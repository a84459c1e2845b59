"""Camera ray generation.

Counterpart of ``gen_rays``, ``unproj_map``, ``_expand_focal``,
``gen_rays_yolo`` and ``gen_rays_yolo_np`` in
pixelnerf_yolo_tpu/utils/camera.py.  NeRF mode: an
OpenGL-style camera (x right, y up, z backward) and camera-to-world poses.
YOLO mode: world-to-camera extrinsics and a pinhole K (z forward).
"""

from __future__ import annotations

import numpy as np
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


def gen_rays_yolo(poses, width: int, height: int, focal, c, z_near,
                  z_far) -> torch.Tensor:
    """Camera rays for YOLO mode, with the reference's quirks:
      * pixel centres at +0.49 (not +0.5);
      * directions K^-1 [u, v, 1] rotated by the inverse extrinsic, NOT
        normalized;
      * origins from the inverse extrinsic's translation.
    K and the extrinsics are inverted with f32 ``torch.linalg.inv``.

    :param poses (B, 4, 4) world-to-camera extrinsics; the rays live on
      its device
    :param focal, c scalars or (fx, fy), (cx, cy)
    :return (B, H, W, 8) = [origin(3), dir(3), near(1), far(1)]
    """
    f32 = torch.float32
    poses = torch.as_tensor(poses, dtype=f32)
    device = poses.device
    n = poses.shape[0]
    focal = torch.as_tensor(focal, dtype=f32, device=device).reshape(-1)
    c = torch.as_tensor(c, dtype=f32, device=device).reshape(-1)
    K = torch.eye(3, dtype=f32, device=device)
    K[0, 0], K[1, 1] = focal[0], focal[-1]
    K[0, 2], K[1, 2] = c[0], c[-1]
    gx = torch.arange(width, dtype=f32, device=device) + 0.49
    gy = torch.arange(height, dtype=f32, device=device) + 0.49
    Y, X = torch.meshgrid(gy, gx, indexing="ij")  # (H, W)
    pix = torch.stack([X, Y, torch.ones_like(X)], dim=-1)
    dirs_cam = torch.einsum("ij,hwj->hwi", torch.linalg.inv(K), pix)
    inv_ext = torch.linalg.inv(poses)
    dirs = torch.einsum("bij,hwj->bhwi", inv_ext[:, :3, :3], dirs_cam)
    origins = inv_ext[:, None, None, :3, 3].expand(n, height, width, 3)
    nears = torch.full((n, height, width, 1), float(z_near), dtype=f32,
                       device=device)
    fars = torch.full((n, height, width, 1), float(z_far), dtype=f32,
                      device=device)
    return torch.cat([origins, dirs, nears, fars], dim=-1)


def gen_rays_yolo_np(poses, width: int, height: int, focal, c, z_near,
                     z_far) -> np.ndarray:
    """``gen_rays_yolo`` on the host in numpy (the trainer's batch
    assembly), with the JAX package's numpy arithmetic.

    :param poses (B, 4, 4) world-to-camera extrinsics
    :return (B, H, W, 8) float32
    """
    poses = np.asarray(poses, dtype=np.float32)
    B = poses.shape[0]
    f = np.asarray(focal, dtype=np.float32).reshape(-1)
    cc = np.asarray(c, dtype=np.float32).reshape(-1)
    K = np.array([[f[0], 0.0, cc[0]], [0.0, f[1], cc[1]], [0.0, 0.0, 1.0]],
                 dtype=np.float32)
    K_inv = np.linalg.inv(K)
    gx = np.arange(width, dtype=np.float32) + 0.49
    gy = np.arange(height, dtype=np.float32) + 0.49
    X, Y = np.meshgrid(gx, gy, indexing="xy")
    pix = np.stack([X, Y, np.ones_like(X)], axis=-1)
    dirs_cam = np.einsum("ij,hwj->hwi", K_inv, pix)
    inv_ext = np.linalg.inv(poses)
    dirs_world = np.einsum("bij,hwj->bhwi", inv_ext[:, :3, :3], dirs_cam)
    origins = np.broadcast_to(inv_ext[:, None, None, :3, 3],
                              (B, height, width, 3))
    nears = np.full((B, height, width, 1), z_near, dtype=np.float32)
    fars = np.full((B, height, width, 1), z_far, dtype=np.float32)
    return np.concatenate(
        [origins, dirs_world.astype(np.float32), nears, fars], axis=-1)
