"""Alpha compositing (NeRF) and probability-weighted aggregation (YOLO).

Counterpart of ``composite`` and ``yolo_aggregate`` in
pixelnerf_yolo_tpu/ops/composite.py.  ``composite``:
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


def yolo_aggregate(out: torch.Tensor, mode: str = "max",
                   soft_count: float = 4.0, gamma: float = 1.0) -> torch.Tensor:
    """Reduce the field's YOLO outputs over the K samples of each ray.

      p_k    = sigmoid(out[..., 0])
      values = sum_k out[..., 1:] p_k / (sum_k p_k + 1e-5)
      prob   = max_k p_k                       (mode "max", the reference)
             = S / (S + soft_count)            (mode "soft_count")
             = max_k p_k * S / (S + soft_count) (mode "gated_count")
    with the objectness mass S = sum_k p_k^gamma.

    :param out (B, K, A, 7) raw field outputs (A anchors)
    :return (B, A, 7) = [prob, weighted values (6)]
    """
    probs = torch.sigmoid(out[..., 0])  # (B, K, A)
    summed = torch.sum(probs, dim=1)  # (B, A)
    vals = torch.sum(out[..., 1:] * probs[..., None], dim=1)
    vals = vals / (summed[..., None] + 1e-5)
    if mode == "max":
        prob = torch.amax(probs, dim=1)
    else:
        mass = summed if gamma == 1.0 else torch.sum(probs**gamma, dim=1)
        squash = mass / (mass + soft_count)
        if mode == "soft_count":
            prob = squash
        elif mode == "gated_count":
            prob = torch.amax(probs, dim=1) * squash
        else:
            raise NotImplementedError(f"Unsupported yolo aggregation {mode!r}")
    return torch.cat([prob[..., None], vals], dim=-1)
