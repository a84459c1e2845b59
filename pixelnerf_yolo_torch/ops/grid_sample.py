"""Grid sampling with torch ``F.grid_sample`` semantics on row-flattened
features.

Counterpart of ``grid_sample_nhwc`` in pixelnerf_yolo_tpu/ops/grid_sample.py:
features live as (B, H*W, C) and each corner lookup is a row gather.  Modes
bilinear and nearest; paddings zeros, border and reflection; both
``align_corners`` conventions.  Non-finite coordinates follow torch: zeros
padding propagates NaN into the output, border and reflection clip NaN and
+inf to the far border and -inf to 0.

``interp_matmul`` reproduces the rounding points of the JAX package's
one-hot matmul form of the bilinear combine (small bf16 tables on the YOLO
path) with the four row gathers; ``grid_sample_nhwc_q8`` samples a
per-channel int8 table (``quantize_rows_int8``, model.latent_int8).

A bilinear lookup of a CUDA table of f32, bf16 or f16 (f32 grid) that
records no gradient runs as one kernel (``latent_gather``,
csrc/latent_gather.cu) with the plain chain's result, bitwise; every other
lookup runs the plain chain (``_corners`` + ``_combine``; with a gradient,
the f32-summed scatter-add backward of ``gather_rows``).  The recorder's
counters ``latent_kernel_points`` and ``latent_plain_points`` count the
points (B x N) of ``grid_sample_nhwc``'s CUDA lookups on each path.
"""

from __future__ import annotations

import torch

from ..utils.profiling import count
from . import latent_gather


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


# rows of the gradient a slice of the f32 scatter-add takes at a time
_GRAD_SLICE = 1 << 16


class _GatherRowsF32Grad(torch.autograd.Function):
    """torch.gather of rows whose backward sums the gradient in f32."""

    @staticmethod
    def forward(ctx, flat, idx):
        ctx.save_for_backward(idx)
        ctx.table = (flat.shape, flat.dtype)
        return torch.gather(flat, 1, idx[..., None].expand(
            -1, -1, flat.shape[-1]))

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        shape, dtype = ctx.table
        acc = torch.zeros(shape, dtype=torch.float32, device=grad.device)
        C = shape[-1]
        for s in range(0, idx.shape[1], _GRAD_SLICE):
            sl = slice(s, s + _GRAD_SLICE)
            acc.scatter_add_(1, idx[:, sl, None].expand(-1, -1, C),
                             grad[:, sl].float())
        return acc.to(dtype), None


def gather_rows(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """flat[b, idx[b, n]]: (B, N, C) rows of a (B, R, C) table.

    Where the table is bf16 or f16 and needs a gradient, the backward
    sums each row's gradient in f32 and rounds it once.  torch.gather's
    own backward on the card adds into the table's dtype by atomics, which
    drop the small terms once a row's sum has grown (hundreds of samples
    land on one latent row); how much is lost depends on how the rays are
    chunked."""
    if (flat.dtype in (torch.bfloat16, torch.float16)
            and flat.requires_grad and torch.is_grad_enabled()):
        return _GatherRowsF32Grad.apply(flat, idx)
    return torch.gather(flat, 1, idx[..., None].expand(-1, -1, flat.shape[-1]))


def _finite_clip(i, size: int):
    i = torch.where(torch.isfinite(i), i, torch.zeros_like(i))
    return torch.clamp(i, 0, size - 1)


def _corners(grid, H: int, W: int, padding_mode: str, align_corners: bool):
    """The four bilinear corners, in the order (x0, y0), (x1, y0), (x0, y1),
    (x1, y1): for each its (B, N) row index (clipped into the table), its
    in-range flag and its f32 weight wx * wy."""
    gx = _unnormalize(grid[..., 0], W, align_corners)
    gy = _unnormalize(grid[..., 1], H, align_corners)
    gx = _apply_padding(gx, W, padding_mode, align_corners)
    gy = _apply_padding(gy, H, padding_mode, align_corners)
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    x1 = x0 + 1
    y1 = y0 + 1
    wx1 = gx - x0
    wy1 = gy - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    out = []
    for ix, iy, wx, wy in ((x0, y0, wx0, wy0), (x1, y0, wx1, wy0),
                           (x0, y1, wx0, wy1), (x1, y1, wx1, wy1)):
        valid = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
        idx = (_finite_clip(iy, H) * W + _finite_clip(ix, W)).to(torch.int64)
        out.append((idx, valid, wx * wy))
    return out


def _interp_matmul(flat, corners):
    """The JAX package's one-hot matmul combine (``interp_matmul``) by four
    row gathers, with its rounding points: NaN table entries zeroed; each
    corner's weight bf16(wx * wy) * valid; the weights of corners that land
    on one row summed in the table's dtype, in corner order (JAX adds the
    four one-hot terms in that dtype); then at most four products of that
    dtype summed in f32 and rounded once."""
    cdt = flat.dtype
    flat = torch.where(torch.isnan(flat), torch.zeros_like(flat), flat)
    idx = [c[0] for c in corners]
    w = [c[2].to(cdt) * c[1].to(cdt) for c in corners]
    zero = torch.zeros((), dtype=cdt, device=flat.device)
    acc = None
    for i in range(4):
        # corner i carries the summed weight of its row when it is the
        # row's first corner, else nothing
        wi = w[i]
        for j in range(i + 1, 4):
            wi = wi + torch.where(idx[j] == idx[i], w[j], zero)
        for j in range(i):
            wi = torch.where(idx[j] == idx[i], zero, wi)
        # bf16 x bf16 products are exact in f32; the sum rounds in f32
        vals, wf = gather_rows(flat, idx[i]), wi.float()[..., None]
        acc = vals * wf if acc is None else torch.addcmul(acc, vals, wf)
    return acc.to(cdt)


def grid_sample_nhwc(
    flat: torch.Tensor,
    grid: torch.Tensor,
    height: int,
    width: int,
    mode: str = "bilinear",
    padding_mode: str = "zeros",
    align_corners: bool = False,
    interp_matmul: bool = False,
) -> torch.Tensor:
    """Sample row-major flattened features at normalized grid locations.

    :param flat (B, H*W, C) feature rows
    :param grid (B, N, 2) in [-1, 1], last dim (x, y)
    :param interp_matmul the bilinear combine at the rounding points of the
      JAX package's one-hot matmul form (``_interp_matmul``); NaN table
      entries contribute 0 there instead of propagating
    :return (B, N, C) in flat's dtype
    """
    H, W = height, width
    on_card = flat.is_cuda
    if (on_card and mode == "bilinear" and not interp_matmul
            and flat.dtype in latent_gather.DTYPES
            # the chain does the coordinates in the grid's dtype (rcnn's
            # grid has its features'); the kernel does them in f32
            and grid.dtype == torch.float32
            and not (torch.is_grad_enabled()
                     and (flat.requires_grad or grid.requires_grad))):
        count("latent_kernel_points", grid.numel() // 2)
        return latent_gather.latent_gather(
            flat.contiguous(), grid.contiguous(), H, W, padding_mode,
            align_corners)
    if on_card:
        count("latent_plain_points", grid.numel() // 2)
    if mode == "bilinear":
        corners = _corners(grid, H, W, padding_mode, align_corners)
        if interp_matmul:
            return _interp_matmul(flat, corners)
        return _combine(flat, corners, flat.dtype)
    if mode != "nearest":
        raise NotImplementedError(f"grid_sample mode {mode!r}")
    gx = _unnormalize(grid[..., 0], W, align_corners)
    gy = _unnormalize(grid[..., 1], H, align_corners)
    ix = torch.round(_apply_padding(gx, W, padding_mode, align_corners))
    iy = torch.round(_apply_padding(gy, H, padding_mode, align_corners))
    valid = ((ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1))
    idx = (_finite_clip(iy, H) * W + _finite_clip(ix, W)).to(torch.int64)
    return gather_rows(flat, idx) * valid.to(flat.dtype)[..., None]


def _combine(flat, corners, dtype):
    """The four-corner bilinear combine in ``dtype``: each corner's rows
    times its in-range flag times its weight, summed in corner order."""
    acc = None
    for idx, valid, w in corners:
        term = (gather_rows(flat, idx).to(dtype) * valid.to(dtype)[..., None]
                * w.to(dtype)[..., None])
        acc = term if acc is None else acc + term
    return acc


def grid_sample_nhwc_q8(flat_q: torch.Tensor, scales: torch.Tensor,
                        grid: torch.Tensor, height: int, width: int,
                        padding_mode: str = "zeros",
                        align_corners: bool = False,
                        out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Bilinear sample from a per-channel int8 table (JAX
    ``grid_sample_nhwc_q8``): each corner's rows cast to out_dtype, times
    its in-range flag and its out_dtype weight, summed in corner order in
    out_dtype; the per-channel scales applied once after the combine.

    :param flat_q (B, H*W, C) int8; scales (C,) f32
    :param grid (B, N, 2) in [-1, 1]
    :return (B, N, C) out_dtype
    """
    acc = _combine(flat_q, _corners(grid, height, width, padding_mode,
                                    align_corners), out_dtype)
    return acc * scales.to(out_dtype)[None, None, :]


def quantize_rows_int8(flat: torch.Tensor):
    """(B, R, C) -> per-channel symmetric int8: (values int8, scales (C,)
    f32), the scale of a channel its absolute max over B and R / 127."""
    f = flat.float()
    absmax = f.abs().amax(dim=(0, 1))
    # a true division on the card too (a Python-number divisor is taken
    # there as a product with its reciprocal)
    scales = torch.clamp(absmax, min=1e-12) / absmax.new_tensor(127.0)
    q = torch.clamp(torch.round(f / scales[None, None, :]), -127, 127)
    return q.to(torch.int8), scales
