"""Camera ray generation for NeRF mode.

Counterpart of ``gen_rays``, ``unproj_map`` and ``_expand_focal`` in
pixelnerf_yolo_tpu/utils/camera.py (OpenGL-style camera: x right, y up,
z backward).
"""

from __future__ import annotations

import torch


def _expand_focal(f, c, width: int, height: int, device):
    """Normalize focal/principal-point formats to ((fx, fy), (cx, cy))."""
    if c is None:
        c = torch.tensor([width * 0.5, height * 0.5], dtype=torch.float32,
                         device=device)
    else:
        c = torch.as_tensor(c, dtype=torch.float32, device=device).squeeze()
        if c.ndim == 0:
            c = torch.stack([c, c])
    f = torch.as_tensor(f, dtype=torch.float32, device=device)
    if f.ndim == 0:
        f = torch.stack([f, f])
    elif f.shape[-1] == 1:
        f = torch.cat([f, f], dim=-1)
    return f, c


def unproj_map(width: int, height: int, f, c=None, device="cuda") -> torch.Tensor:
    """(H, W, 3) unit ray directions in the camera frame, (X, -Y, -Z)."""
    f, c = _expand_focal(f, c, width, height, device)
    x = (torch.arange(width, dtype=torch.float32, device=device) - c[0]) / f[0]
    y = (torch.arange(height, dtype=torch.float32, device=device) - c[1]) / f[1]
    Y, X = torch.meshgrid(y, x, indexing="ij")  # (H, W)
    Z = torch.ones_like(X)
    unproj = torch.stack([X, -Y, -Z], dim=-1)
    return unproj / torch.linalg.vector_norm(unproj, dim=-1, keepdim=True)


def gen_rays(poses, width: int, height: int, focal, z_near, z_far, c=None,
             ndc: bool = False) -> torch.Tensor:
    """Camera rays for NeRF mode.

    :param poses (B, 4, 4) camera-to-world; the rays live on its device
    :return (B, H, W, 8) = [origin(3), unit dir(3), near(1), far(1)]
    """
    if ndc:
        raise NotImplementedError("NDC rays are not ported yet")
    poses = torch.as_tensor(poses, dtype=torch.float32)
    device = poses.device
    n = poses.shape[0]
    focal = torch.as_tensor(focal, dtype=torch.float32, device=device).squeeze()
    dirs_cam = unproj_map(width, height, focal, c=c, device=device)
    centers = poses[:, None, None, :3, 3].expand(n, height, width, 3)
    raydirs = torch.einsum("bij,hwj->bhwi", poses[:, :3, :3], dirs_cam)
    nears = torch.full((n, height, width, 1), float(z_near),
                       dtype=torch.float32, device=device)
    fars = torch.full((n, height, width, 1), float(z_far),
                      dtype=torch.float32, device=device)
    return torch.cat([centers, raydirs, nears, fars], dim=-1)
