"""The reference's pixelNeRF training step (Yu et al. 2021, the published
SRN recipe ``train.py -B <SB> -V <NS>``): a batch of SB objects, each with
NS source views drawn at random and ``ray_batch_size`` target rays whose
pixels are drawn inside the objects' per-view bounding boxes; the encoder
with BatchNorm on the batch's statistics; the coarse and fine passes; the
mean squared error of both passes' colours (lambda 1 each); Adam.

Departures from the published description: the view choice and the pixel
draws come from a numpy generator, replayed here in the order the
program under test draws them (a count of source views, then per object
its views and ``bbox_sample``'s image ids, columns and rows), and the
render's random numbers come in as draws; with a seed both sides see the
same batch.
"""

from __future__ import annotations

import numpy as np
import torch

from .render import composite, sample_coarse, sample_fine


def pixel_rays(poses, ids, x, y, focal: float, size: int, near: float,
               far: float) -> np.ndarray:
    """(R, 8) rays [origin, unit direction, near, far] of pixels (x, y) of
    views ids; poses (V, 4, 4) camera-to-world, pixel (x, y) along
    ((x - c) / f, -(y - c) / f, -1) in the camera, c the centre."""
    c = size * 0.5
    d = np.stack([(x - c) / focal, -(y - c) / focal, -np.ones(len(x))], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pose = np.asarray(poses, np.float64)[ids]
    d = np.einsum("rij,rj->ri", pose[:, :3, :3], d)
    nf = np.broadcast_to([near, far], (len(x), 2))
    return np.concatenate([pose[:, :3, 3], d, nf], -1).astype(np.float32)


def nerf_batch(objects, rng, ns: int, R: int, near: float, far: float):
    """The step's inputs from SB objects {images (V, 3, S, S) in [-1, 1],
    poses (V, 4, 4) camera-to-world, focal, bbox (V, 4) [cmin, rmin, cmax,
    rmax]}: -> (source images (SB, NS, 3, S, S), source poses, focal (SB,),
    rays (SB, R, 8), colours (SB, R, 3) in [0, 1])."""
    rng.integers(0, 1)  # the count of source views, of one choice
    src, src_poses, rays, rgb = [], [], [], []
    for o in objects:
        V, _, S, _ = o["images"].shape
        sel = rng.choice(V, ns, replace=False)
        ids = rng.integers(0, V, size=R)
        bb = o["bbox"][ids]
        x = (rng.random(R) * (bb[:, 2] + 1 - bb[:, 0]) + bb[:, 0]).astype(
            np.int64)
        y = (rng.random(R) * (bb[:, 3] + 1 - bb[:, 1]) + bb[:, 1]).astype(
            np.int64)
        src.append(o["images"][sel])
        src_poses.append(o["poses"][sel])
        rays.append(pixel_rays(o["poses"], ids, x, y, float(o["focal"]), S,
                               near, far))
        rgb.append(o["images"][ids, :, y, x] * 0.5 + 0.5)
    return (np.stack(src), np.stack(src_poses),
            np.asarray([o["focal"] for o in objects], np.float32),
            np.stack(rays), np.stack(rgb))


def render_batch(model, cond, rays, draws, r):
    """Coarse and fine colours (SB * R, 3) of rays (SB, R, 8): the field
    of each object's rays conditioned on that object's views."""
    sb = rays.shape[0]
    flat = rays.reshape(-1, 8)
    near, far = flat[:, 6:7], flat[:, 7:8]

    def field(z, coarse):
        pts = flat[:, None, :3] + z[..., None] * flat[:, None, 3:6]
        dirs = flat[:, None, 3:6].expand_as(pts)
        return model(cond, pts.reshape(sb, -1, 3), dirs.reshape(sb, -1, 3),
                     coarse=coarse).reshape(z.shape[0], z.shape[1], -1)

    z_c = sample_coarse(flat, r["n_coarse"], draws["u_coarse"])
    w_c, rgb_c, depth_c = composite(field(z_c, True), z_c, far,
                                    r["white_bkgd"])
    z_f = sample_fine(flat, w_c, r["n_coarse"], draws["u"],
                      draws["u_jitter"])
    z_d = depth_c[:, None] + draws["noise_d"] * r["depth_std"]
    z_d = torch.maximum(torch.minimum(z_d, far), near)
    z_u = torch.sort(torch.cat([z_c, z_f, z_d], -1), dim=-1,
                     stable=True).values
    _, rgb_f, _ = composite(field(z_u, False), z_u, far, r["white_bkgd"])
    return rgb_c, rgb_f


def nerf_step(model, opt, batch, draws, r, device):
    """One update on ``nerf_batch``'s inputs; -> (loss, {name: gradient})."""
    src, src_poses, focal, rays, rgb = (torch.as_tensor(a, device=device)
                                        for a in batch)
    cond = model.encode(src, src_poses, focal[:, None], train=True)
    rgb_c, rgb_f = render_batch(model, cond, rays, draws, r)
    gt = rgb.reshape(-1, 3)
    loss = ((rgb_c - gt) ** 2).mean() + ((rgb_f - gt) ** 2).mean()
    opt.zero_grad(set_to_none=True)
    loss.backward()
    grads = {n: p.grad.detach().clone() if p.grad is not None
             else torch.zeros_like(p) for n, p in model.named_parameters()}
    opt.step()
    return float(loss.detach()), grads
