"""Shared host-side dataset helpers (pure numpy).

Counterpart of pixelnerf_yolo_tpu/data/base.py: [-1,1] CHW image
conversion, mask -> bbox extraction, and an exact F.interpolate(mode="area")
equivalent for batched CHW stacks.  imageio is an optional import (None
when missing); a reader that needs it raises.
"""

from __future__ import annotations

import numpy as np

try:
    import imageio.v2 as imageio
except ImportError:  # pragma: no cover
    try:
        import imageio
    except ImportError:
        imageio = None

from ..utils.image import image_to_tensor_balanced, mask_to_tensor

__all__ = [
    "imageio",
    "image_to_tensor_balanced",
    "mask_to_tensor",
    "mask_bbox",
    "area_resize_chw",
]


def mask_bbox(mask: np.ndarray, rgb_path: str = "?") -> np.ndarray:
    """Tight bbox [cmin, rmin, cmax, rmax] of a nonzero mask (HW or HWC)."""
    if mask.ndim == 3:
        mask2d = mask[..., 0]
    else:
        mask2d = mask
    rows = np.any(mask2d, axis=1)
    cols = np.any(mask2d, axis=0)
    rnz = np.where(rows)[0]
    cnz = np.where(cols)[0]
    if len(rnz) == 0:
        raise RuntimeError("ERROR: Bad image at", rgb_path, "please investigate!")
    rmin, rmax = rnz[[0, -1]]
    cmin, cmax = cnz[[0, -1]]
    return np.array([cmin, rmin, cmax, rmax], dtype=np.float32)


def _area_matrix(n_out: int, n_in: int) -> np.ndarray:
    m = np.zeros((n_out, n_in), dtype=np.float64)
    scale = n_in / n_out
    for i in range(n_out):
        lo, hi = i * scale, (i + 1) * scale
        for j in range(int(np.floor(lo)), int(np.ceil(hi))):
            m[i, j] = min(hi, j + 1) - max(lo, j)
    return (m / scale).astype(np.float32)


def area_resize_chw(x: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """(N, C, H, W) -> (N, C, out_h, out_w), torch mode='area' semantics."""
    n, c, h, w = x.shape
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x
    mh = _area_matrix(oh, h)
    mw = _area_matrix(ow, w)
    y = np.einsum("oh,nchw->ncow", mh, x)
    return np.einsum("pw,ncow->ncop", mw, y).astype(x.dtype)
