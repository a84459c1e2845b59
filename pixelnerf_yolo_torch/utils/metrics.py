"""Quality metrics: PSNR and SSIM (numpy, float64).

Counterpart of pixelnerf_yolo_tpu/utils/metrics.py.  SSIM is
scikit-image's ``structural_similarity`` with the defaults the evaluation
uses (data_range 1, multichannel, 7x7 uniform window, K1 0.01, K2 0.03,
sample covariance N/(N-1)), without scikit-image.
"""

from __future__ import annotations

import math

import numpy as np


def psnr(pred, target) -> float:
    """PSNR in dB: -10 log10(mse)."""
    pred = np.asarray(pred, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    mse = float(np.mean((pred - target) ** 2))
    return -10.0 * math.log10(mse)


def _uniform_filter(img: np.ndarray, size: int) -> np.ndarray:
    """Separable uniform (mean) filter with reflect padding, same-size out."""
    pad = size // 2
    out = img.astype(np.float64)
    for axis in range(2):
        padded = np.pad(
            out,
            [(pad, pad) if a == axis else (0, 0) for a in range(out.ndim)],
            mode="reflect",
        )
        kernel_shape = [1] * out.ndim
        kernel_shape[axis] = size
        cs = np.cumsum(padded, axis=axis)
        zero = np.zeros_like(np.take(cs, [0], axis=axis))
        cs = np.concatenate([zero, cs], axis=axis)
        hi = np.take(cs, range(size, cs.shape[axis]), axis=axis)
        lo = np.take(cs, range(0, cs.shape[axis] - size), axis=axis)
        out = (hi - lo) / size
    return out


def ssim(
    im1: np.ndarray,
    im2: np.ndarray,
    data_range: float = 1.0,
    multichannel: bool = True,
    win_size: int = 7,
    k1: float = 0.01,
    k2: float = 0.03,
) -> float:
    """Mean structural similarity (skimage-compatible uniform-window SSIM)."""
    im1 = np.asarray(im1, dtype=np.float64)
    im2 = np.asarray(im2, dtype=np.float64)
    if multichannel and im1.ndim == 3:
        return float(
            np.mean([
                ssim(
                    im1[..., ch],
                    im2[..., ch],
                    data_range=data_range,
                    multichannel=False,
                    win_size=win_size,
                    k1=k1,
                    k2=k2,
                )
                for ch in range(im1.shape[-1])
            ])
        )

    n = win_size**2
    cov_norm = n / (n - 1.0)  # sample covariance, as in skimage

    ux = _uniform_filter(im1, win_size)
    uy = _uniform_filter(im2, win_size)
    uxx = _uniform_filter(im1 * im1, win_size)
    uyy = _uniform_filter(im2 * im2, win_size)
    uxy = _uniform_filter(im1 * im2, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    a1 = 2 * ux * uy + c1
    a2 = 2 * vxy + c2
    b1 = ux**2 + uy**2 + c1
    b2 = vx + vy + c2
    s = (a1 * a2) / (b1 * b2)

    # crop the filter's edge effects, as skimage does
    pad = (win_size - 1) // 2
    s = s[pad:-pad, pad:-pad] if pad > 0 else s
    return float(s.mean())
