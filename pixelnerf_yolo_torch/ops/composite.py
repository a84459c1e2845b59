"""Alpha compositing (volume rendering quadrature).

Counterpart of ``composite`` in pixelnerf_yolo_tpu/ops/composite.py:
  deltas_k = z_{k+1} - z_k,  delta_K = far - z_K
  alpha_k  = 1 - exp(-delta_k * relu(sigma_k))
  T_k      = prod_{j<k} (1 - alpha_j + 1e-10)
  w_k      = alpha_k * T_k
  rgb      = sum_k w_k rgb_k  (+ (1 - sum w) if white_bkgd)
  depth    = sum_k w_k z_k
"""

from __future__ import annotations

import torch


def composite(rgb_sigma: torch.Tensor, z_samp: torch.Tensor,
              far: torch.Tensor, white_bkgd: bool = False,
              sigma_noise: torch.Tensor | None = None):
    """:param rgb_sigma (B, K, 4); z_samp (B, K) sorted; far (B,) or (B, 1)
    :return (weights (B, K), rgb (B, 3), depth (B,))
    """
    far = far.reshape(far.shape[0], -1)[:, -1:]
    deltas = torch.cat(
        [z_samp[:, 1:] - z_samp[:, :-1], far - z_samp[:, -1:]], dim=-1
    )
    rgbs = rgb_sigma[..., :3]
    sigmas = rgb_sigma[..., 3]
    if sigma_noise is not None:
        sigmas = sigmas + sigma_noise
    alphas = 1.0 - torch.exp(-deltas * torch.relu(sigmas))
    alphas_shifted = torch.cat(
        [torch.ones_like(alphas[:, :1]), 1.0 - alphas + 1e-10], dim=-1
    )
    T = torch.cumprod(alphas_shifted, dim=-1)
    weights = alphas * T[:, :-1]
    rgb_final = torch.sum(weights[..., None] * rgbs, dim=-2)
    depth_final = torch.sum(weights * z_samp, dim=-1)
    if white_bkgd:
        rgb_final = rgb_final + (1.0 - torch.sum(weights, dim=-1))[..., None]
    return weights, rgb_final, depth_final
