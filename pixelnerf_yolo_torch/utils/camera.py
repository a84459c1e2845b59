"""Camera ray generation.

Counterpart of ``gen_rays``, ``ndc_rays``, ``unproj_map``, ``_expand_focal``,
``gen_rays_yolo``, ``gen_rays_np`` and ``gen_rays_yolo_np`` in
pixelnerf_yolo_tpu/utils/camera.py, and ``gen_rays_at_np``, the rays of
chosen pixels only.  NeRF mode: an
OpenGL-style camera (x right, y up, z backward) and camera-to-world poses.
YOLO mode: world-to-camera extrinsics and a pinhole K (z forward).

Also the pose constructors of the evaluation CLIs' trajectories, numpy
copies of the JAX package's (``coord_from_blender`` ... ``dtu_trajectory``),
and ``quat_to_rot`` / ``rot_to_quat`` in torch.
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
    :param ndc the rays mapped into NDC space (``ndc_rays`` with near 1),
      with near 0 and far 1
    :return (B, H, W, 8) = [origin(3), unit dir(3), near(1), far(1)]
    """
    poses = torch.as_tensor(poses, dtype=torch.float32)
    device = poses.device
    n = poses.shape[0]
    focal = torch.as_tensor(focal, dtype=torch.float32, device=device).squeeze()
    dirs_cam = unproj_map(width, height, focal, c=c, device=device)
    centers = poses[:, None, None, :3, 3].expand(n, height, width, 3)
    raydirs = torch.einsum("bij,hwj->bhwi", poses[:, :3, :3], dirs_cam)
    if ndc:
        z_near, z_far = 0.0, 1.0
        centers, raydirs = ndc_rays(width, height, focal, 1.0, centers,
                                    raydirs)
    nears = torch.full((n, height, width, 1), float(z_near),
                       dtype=torch.float32, device=device)
    fars = torch.full((n, height, width, 1), float(z_far),
                      dtype=torch.float32, device=device)
    return torch.cat([centers, raydirs, nears, fars], dim=-1)


def ndc_rays(width, height, focal, near, rays_o, rays_d):
    """Shift rays to the z = -near plane and map them to NDC space (the
    standard NeRF transform; focal a scalar or (fx, fy))."""
    focal = torch.as_tensor(focal, dtype=torch.float32, device=rays_o.device)
    fx = focal if focal.ndim == 0 else focal.reshape(-1)[0]
    fy = focal if focal.ndim == 0 else focal.reshape(-1)[-1]
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d
    ox, oy, oz = rays_o.unbind(-1)
    dx, dy, dz = rays_d.unbind(-1)
    o = torch.stack([-fx * 2.0 / width * ox / oz,
                     -fy * 2.0 / height * oy / oz,
                     1.0 + 2.0 * near / oz], dim=-1)
    d = torch.stack([-fx * 2.0 / width * (dx / dz - ox / oz),
                     -fy * 2.0 / height * (dy / dz - oy / oz),
                     -2.0 * near / oz], dim=-1)
    return o, d


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


def gen_rays_yolo_scales(poses, width: int, height: int, focal, c,
                         cell_sizes, z_near, z_far):
    """The cell rays of every grid of a multi-scale YOLO head in one batch:
    grid s has (height // cs) x (width // cs) cells for cs = cell_sizes[s],
    its rays ``gen_rays_yolo`` at focal / cs and c / cs (as the trainer's
    vis_step builds each grid), flattened in (h, w) order and concatenated
    grid by grid.

    :param poses (B, 4, 4) world-to-camera extrinsics
    :param focal, c (fx, fy) and (cx, cy) in pixels (or scalars)
    :return (rays (B, N, 8), grids [(h, w)] of each grid, in order: the
      shape ``detect.nms.decode_scales`` takes)
    """
    parts, grids = [], []
    for cs in cell_sizes:
        grids.append((height // cs, width // cs))
        r = gen_rays_yolo(poses, width // cs, height // cs,
                          torch.as_tensor(focal) / cs,
                          torch.as_tensor(c) / cs, z_near, z_far)
        parts.append(r.reshape(r.shape[0], -1, 8))
    return torch.cat(parts, dim=1), grids


def _expand_focal_np(focal, c, width: int, height: int):
    """``_expand_focal`` in float32 numpy: ((fx, fy), (cx, cy))."""
    f = np.asarray(focal, dtype=np.float32).squeeze()
    if f.ndim == 0:
        f = np.stack([f, f])
    elif f.shape[-1] == 1:
        f = np.concatenate([f, f], axis=-1)
    if c is None:
        cc = np.asarray([width * 0.5, height * 0.5], dtype=np.float32)
    else:
        cc = np.asarray(c, dtype=np.float32).squeeze()
        if cc.ndim == 0:
            cc = np.stack([cc, cc])
    return f, cc


def gen_rays_np(poses, width: int, height: int, focal, z_near, z_far,
                c=None) -> np.ndarray:
    """``gen_rays`` on the host in numpy, with the JAX package's numpy
    arithmetic; no NDC.

    :param poses (B, 4, 4) camera-to-world
    :return (B, H, W, 8) float32
    """
    poses = np.asarray(poses, dtype=np.float32)
    f, cc = _expand_focal_np(focal, c, width, height)
    x = (np.arange(width, dtype=np.float32) - cc[0]) / f[0]
    y = (np.arange(height, dtype=np.float32) - cc[1]) / f[1]
    X, Y = np.meshgrid(x, y, indexing="xy")
    unproj = np.stack([X, -Y, -np.ones_like(X)], axis=-1)
    dirs_cam = unproj / np.linalg.norm(unproj, axis=-1, keepdims=True)

    B = poses.shape[0]
    centers = np.broadcast_to(
        poses[:, None, None, :3, 3], (B, height, width, 3)
    )
    raydirs = np.einsum("bij,hwj->bhwi", poses[:, :3, :3], dirs_cam)
    nears = np.full((B, height, width, 1), z_near, dtype=np.float32)
    fars = np.full((B, height, width, 1), z_far, dtype=np.float32)
    return np.concatenate(
        [centers, raydirs.astype(np.float32), nears, fars], axis=-1
    )


def gen_rays_at_np(poses, view, row, col, width: int, height: int, focal,
                   z_near, z_far, c=None) -> np.ndarray:
    """The rays of some pixels only (the NeRF trainer's batch assembly):
    ``gen_rays_np(...)[view, row, col]`` bitwise, in the same float32
    arithmetic, without building the other pixels' rays.

    :param poses (B, 4, 4) camera-to-world
    :param view, row, col (N,) integer indices of the pixels
    :return (N, 8) float32
    """
    poses = np.asarray(poses, dtype=np.float32)
    f, cc = _expand_focal_np(focal, c, width, height)
    x = (np.asarray(col).astype(np.float32) - cc[0]) / f[0]
    y = (np.asarray(row).astype(np.float32) - cc[1]) / f[1]
    unproj = np.stack([x, -y, -np.ones_like(x)], axis=-1)
    dirs_cam = unproj / np.linalg.norm(unproj, axis=-1, keepdims=True)
    rot = poses[view, :3, :3]
    raydirs = np.einsum("nij,nj->ni", rot, dirs_cam)
    n = x.shape[0]
    nears = np.full((n, 1), z_near, dtype=np.float32)
    fars = np.full((n, 1), z_far, dtype=np.float32)
    return np.concatenate(
        [poses[view, :3, 3], raydirs.astype(np.float32), nears, fars], axis=-1
    )


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


# -- pose constructors (host side) -------------------------------------------


def coord_from_blender() -> np.ndarray:
    return np.array([[1, 0, 0, 0], [0, 0, 1, 0], [0, -1, 0, 0], [0, 0, 0, 1]],
                    dtype=np.float32)


def coord_to_blender() -> np.ndarray:
    return np.array([[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
                    dtype=np.float32)


def look_at(origin, target, world_up=None) -> np.ndarray:
    """4x4 camera-to-world for a camera at ``origin`` looking at ``target``."""
    if world_up is None:
        world_up = np.array([0, 1, 0], dtype=np.float32)
    origin = np.asarray(origin, dtype=np.float32)
    back = origin - np.asarray(target, dtype=np.float32)
    back /= np.linalg.norm(back)
    right = np.cross(world_up, back)
    right /= np.linalg.norm(right)
    up = np.cross(back, right)
    c2w = np.empty((4, 4), dtype=np.float32)
    c2w[:3, 0] = right
    c2w[:3, 1] = up
    c2w[:3, 2] = back
    c2w[:3, 3] = origin
    c2w[3, :] = [0, 0, 0, 1]
    return c2w


def trans_t(t: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[2, 3] = t
    return m


def rot_phi(phi: float) -> np.ndarray:
    cp, sp = np.cos(phi), np.sin(phi)
    return np.array(
        [[1, 0, 0, 0], [0, cp, -sp, 0], [0, sp, cp, 0], [0, 0, 0, 1]],
        dtype=np.float32)


def rot_theta(th: float) -> np.ndarray:
    ct, st = np.cos(th), np.sin(th)
    return np.array(
        [[ct, 0, -st, 0], [0, 1, 0, 0], [st, 0, ct, 0], [0, 0, 0, 1]],
        dtype=np.float32)


def rot_kappa(kappa: float) -> np.ndarray:
    ck, sk = np.cos(kappa), np.sin(kappa)
    return np.array(
        [[ck, -sk, 0, 0], [sk, ck, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
        dtype=np.float32)


_SPHERICAL_FLIP = np.array(
    [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
    dtype=np.float32)
_SPHERICAL2_FLIP = np.array(
    [[-1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
    dtype=np.float32)


def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """360-degree orbit pose (NeRF convention), angles in degrees."""
    c2w = trans_t(radius)
    c2w = rot_phi(phi / 180.0 * np.pi) @ c2w
    c2w = rot_theta(theta / 180.0 * np.pi) @ c2w
    return _SPHERICAL_FLIP @ c2w


def pose_spherical2(theta: float, kappa: float, radius: float) -> np.ndarray:
    c2w = trans_t(radius)
    c2w = rot_kappa(kappa / 180.0 * np.pi) @ c2w
    c2w = rot_theta(theta / 180.0 * np.pi) @ c2w
    return _SPHERICAL2_FLIP @ c2w


# IDR's DTU fly-through keyframes: times, camera quaternions [w, x, y, z]
# (periodic: the last is the first) and radial scales
_DTU_TRAJ_T = np.array([0, 2, 3, 5, 6], dtype=np.float32)
_DTU_TRAJ_QUAT = np.array(
    [
        [0.9698, 0.2121, 0.1203, -0.0039],
        [0.7020, 0.1578, 0.4525, 0.5268],
        [0.6766, 0.3176, 0.5179, 0.4161],
        [0.9085, 0.4020, 0.1139, -0.0025],
        [0.9698, 0.2121, 0.1203, -0.0039],
    ],
    dtype=np.float32,
)
_DTU_TRAJ_SCALE = np.array([2.0] * 5, dtype=np.float32)


def dtu_trajectory(num_views: int) -> np.ndarray:
    """IDR DTU fly-through poses (F, 4, 4), F = 6 * max(num_views // 5, 1):
    a periodic cubic spline through the quaternion keyframes above,
    renormalized per frame, the camera at R[:, 2] * scale."""
    from scipy.interpolate import CubicSpline

    n_inter = max(num_views // 5, 1)
    t_out = np.linspace(
        _DTU_TRAJ_T[0], _DTU_TRAJ_T[-1], n_inter * int(_DTU_TRAJ_T[-1]),
        endpoint=False,
    ).astype(np.float32)
    s_new = CubicSpline(_DTU_TRAJ_T, _DTU_TRAJ_SCALE, bc_type="periodic")(
        t_out)
    q_new = CubicSpline(_DTU_TRAJ_T, _DTU_TRAJ_QUAT, bc_type="periodic")(
        t_out)
    q_new = q_new / np.linalg.norm(q_new, 2, axis=1)[:, None]

    R = quat_to_rot(torch.from_numpy(q_new.astype(np.float32))).numpy()
    poses = np.tile(np.eye(4, dtype=np.float32), (len(t_out), 1, 1))
    poses[:, :3, :3] = R
    poses[:, :3, 3] = R[:, :, 2] * s_new[:, None].astype(np.float32)
    return poses


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Quaternions (B, 4) [w, x, y, z], unit-normalized here -> rotation
    matrices (B, 3, 3)."""
    q = q / torch.linalg.norm(q, dim=1, keepdim=True)
    qr, qi, qj, qk = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r00 = 1 - 2 * (qj**2 + qk**2)
    r01 = 2 * (qj * qi - qk * qr)
    r02 = 2 * (qi * qk + qr * qj)
    r10 = 2 * (qj * qi + qk * qr)
    r11 = 1 - 2 * (qi**2 + qk**2)
    r12 = 2 * (qj * qk - qi * qr)
    r20 = 2 * (qk * qi - qj * qr)
    r21 = 2 * (qj * qk + qi * qr)
    r22 = 1 - 2 * (qi**2 + qj**2)
    return torch.stack([
        torch.stack([r00, r01, r02], dim=-1),
        torch.stack([r10, r11, r12], dim=-1),
        torch.stack([r20, r21, r22], dim=-1),
    ], dim=-2)


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (B, 3, 3) -> quaternions (B, 4) [w, x, y, z]."""
    w = torch.sqrt(1.0 + R[:, 0, 0] + R[:, 1, 1] + R[:, 2, 2]) / 2.0
    x = (R[:, 2, 1] - R[:, 1, 2]) / (4 * w)
    y = (R[:, 0, 2] - R[:, 2, 0]) / (4 * w)
    z = (R[:, 1, 0] - R[:, 0, 1]) / (4 * w)
    return torch.stack([w, x, y, z], dim=-1)
