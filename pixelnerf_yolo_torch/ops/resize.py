"""Bilinear resize with torch ``F.interpolate`` semantics, as two matmuls.

Counterpart of ``resize_bilinear`` in pixelnerf_yolo_tpu/ops/resize.py: the
same separable interpolation matrices, built in numpy, contracted in f32.
"""

from __future__ import annotations

import numpy as np
import torch


def _interp_matrix(n_out: int, n_in: int, align_corners: bool) -> np.ndarray:
    """Row i holds the linear-interp weights of output sample i."""
    m = np.zeros((n_out, n_in), dtype=np.float32)
    if n_in == 1:
        m[:, 0] = 1.0
        return m
    for i in range(n_out):
        if align_corners:
            src = i * (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
        else:
            src = (i + 0.5) * n_in / n_out - 0.5
            src = min(max(src, 0.0), n_in - 1)
        lo = int(np.floor(src))
        hi = min(lo + 1, n_in - 1)
        w = src - lo
        m[i, lo] += 1.0 - w
        m[i, hi] += w
    return m


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int],
                    align_corners: bool = True) -> torch.Tensor:
    """Resize (B, C, H, W) -> (B, C, out_h, out_w) in f32; returns x itself
    when the size already matches."""
    _, _, H, W = x.shape
    out_h, out_w = out_hw
    if (H, W) == (out_h, out_w):
        return x
    mh = torch.from_numpy(_interp_matrix(out_h, H, align_corners)).to(x.device)
    mw = torch.from_numpy(_interp_matrix(out_w, W, align_corners)).to(x.device)
    y = torch.einsum("oh,bchw->bcow", mh, x.float())
    return torch.einsum("pw,bcow->bcop", mw, y)
