"""Grid sampling with torch ``F.grid_sample`` semantics on row-flattened
features.

Counterpart of ``grid_sample_nhwc`` in pixelnerf_yolo_tpu/ops/grid_sample.py:
features live as (B, H*W, C) and each corner lookup is a row gather.  Modes
bilinear and nearest; paddings zeros, border and reflection; both
``align_corners`` conventions.  Non-finite coordinates follow torch: zeros
padding propagates NaN into the output, border and reflection clip NaN and
+inf to the far border and -inf to 0.
"""

from __future__ import annotations

import torch


def _unnormalize(coord, size: int, align_corners: bool):
    """[-1, 1] -> pixel coordinates, torch convention."""
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


def _reflect(coord, low: float, high: float):
    """Reflect coordinates into [low, high] (torch reflect_coordinates)."""
    span = high - low
    if span <= 0:
        return torch.zeros_like(coord)
    # fmod is exact (torch.remainder rounds a - b * floor(a / b))
    coord = torch.fmod(torch.abs(coord - low), 2 * span)
    return low + torch.where(coord > span, 2 * span - coord, coord)


def _torch_clip(coord, size: int):
    """torch clip_coordinates: +inf -> size-1, -inf -> 0, NaN -> 0."""
    clipped = torch.clamp(coord, 0, size - 1)
    return torch.where(torch.isnan(coord), torch.zeros_like(coord), clipped)


def _apply_padding(coord, size: int, padding_mode: str, align_corners: bool):
    if padding_mode == "border":
        return _torch_clip(coord, size)
    if padding_mode == "reflection":
        if align_corners:
            coord = _reflect(coord, 0.0, float(size - 1))
        else:
            coord = _reflect(coord, -0.5, size - 0.5)
        return _torch_clip(coord, size)
    if padding_mode != "zeros":
        raise NotImplementedError(f"grid_sample padding {padding_mode!r}")
    return coord  # zeros: OOB/non-finite handled by per-corner masking


def _finite_clip(i, size: int):
    i = torch.where(torch.isfinite(i), i, torch.zeros_like(i))
    return torch.clamp(i, 0, size - 1)


def grid_sample_nhwc(
    flat: torch.Tensor,
    grid: torch.Tensor,
    height: int,
    width: int,
    mode: str = "bilinear",
    padding_mode: str = "zeros",
    align_corners: bool = False,
) -> torch.Tensor:
    """Sample row-major flattened features at normalized grid locations.

    :param flat (B, H*W, C) feature rows
    :param grid (B, N, 2) in [-1, 1], last dim (x, y)
    :return (B, N, C) in flat's dtype
    """
    H, W = height, width
    C = flat.shape[-1]
    gx = _unnormalize(grid[..., 0], W, align_corners)
    gy = _unnormalize(grid[..., 1], H, align_corners)
    gx = _apply_padding(gx, W, padding_mode, align_corners)
    gy = _apply_padding(gy, H, padding_mode, align_corners)
    cdt = flat.dtype

    def gather(ix, iy, valid):
        idx = (iy * W + ix).to(torch.int64)  # (B, N)
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C))
        return vals * valid[..., None]

    def in_range(ix, iy):
        return ((ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)).to(cdt)

    if mode == "nearest":
        ix = torch.round(gx)
        iy = torch.round(gy)
        valid = in_range(ix, iy)
        return gather(_finite_clip(ix, W), _finite_clip(iy, H), valid)
    if mode != "bilinear":
        raise NotImplementedError(f"grid_sample mode {mode!r}")

    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    x1 = x0 + 1
    y1 = y0 + 1
    wx1 = gx - x0
    wy1 = gy - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1

    def corner(ix, iy, wx, wy):
        w = (wx * wy).to(cdt)
        vals = gather(_finite_clip(ix, W), _finite_clip(iy, H), in_range(ix, iy))
        return vals * w[..., None]

    return (
        corner(x0, y0, wx0, wy0)
        + corner(x1, y0, wx1, wy0)
        + corner(x0, y1, wx0, wy1)
        + corner(x1, y1, wx1, wy1)
    )
