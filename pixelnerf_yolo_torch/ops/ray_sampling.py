"""Ray point sampling: stratified coarse, importance fine, depth-gaussian.

Counterpart of pixelnerf_yolo_tpu/ops/ray_sampling.py.  Each sampler takes
its random draws injected (``u=``, ``u_jitter=``, ``noise=``) or draws them
from an explicit ``torch.Generator`` on the rays' device.
"""

from __future__ import annotations

import torch


def _lerp_depth(rays, z_steps, lindisp: bool):
    near, far = rays[:, -2:-1], rays[:, -1:]
    if not lindisp:
        return near * (1.0 - z_steps) + far * z_steps
    return 1.0 / (1.0 / near * (1.0 - z_steps) + 1.0 / far * z_steps)


def sample_coarse(rays: torch.Tensor, n_coarse: int,
                  generator: torch.Generator | None = None,
                  lindisp: bool = False,
                  u: torch.Tensor | None = None) -> torch.Tensor:
    """Stratified uniform samples in [near, far].

    :param rays (B, 8)
    :return z (B, n_coarse)
    """
    B = rays.shape[0]
    step = 1.0 / n_coarse
    z_steps = torch.linspace(0.0, 1.0 - step, n_coarse, dtype=rays.dtype,
                             device=rays.device)[None].expand(B, n_coarse)
    if u is None:
        u = torch.rand((B, n_coarse), generator=generator, dtype=rays.dtype,
                       device=rays.device)
    return _lerp_depth(rays, z_steps + u * step, lindisp)


def sample_fine(rays: torch.Tensor, weights: torch.Tensor, n_fine: int,
                n_coarse: int, generator: torch.Generator | None = None,
                lindisp: bool = False, u: torch.Tensor | None = None,
                u_jitter: torch.Tensor | None = None) -> torch.Tensor:
    """Importance samples from the coarse weight CDF (inverse CDF by
    comparison count, minus one, clamped, plus an intra-bin jitter).

    :param rays (B, 8); weights (B, Kc), treated as constants
    :return z (B, n_fine)
    """
    B = rays.shape[0]
    weights = weights.detach() + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)  # (B, Kc+1)
    if u is None:
        u = torch.rand((B, n_fine), generator=generator, dtype=rays.dtype,
                       device=rays.device)
    inds = torch.sum((cdf[:, :, None] <= u[:, None, :]).to(rays.dtype), dim=1)
    inds = torch.clamp(inds - 1.0, min=0.0)
    if u_jitter is None:
        u_jitter = torch.rand((B, n_fine), generator=generator,
                              dtype=rays.dtype, device=rays.device)
    return _lerp_depth(rays, (inds + u_jitter) / n_coarse, lindisp)


def sample_fine_depth(rays: torch.Tensor, depth: torch.Tensor,
                      n_fine_depth: int,
                      generator: torch.Generator | None = None,
                      depth_std: float = 0.01,
                      noise: torch.Tensor | None = None) -> torch.Tensor:
    """Gaussian samples around the expected depth, clamped to [near, far]."""
    B = rays.shape[0]
    z = depth[:, None].expand(B, n_fine_depth)
    if noise is None:
        noise = torch.randn((B, n_fine_depth), generator=generator,
                            dtype=rays.dtype, device=rays.device)
    z = z + noise * depth_std
    return torch.maximum(torch.minimum(z, rays[:, -1:]), rays[:, -2:-1])
