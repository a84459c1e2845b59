"""The reference's YOLO training step: the batch of one scene (source
views drawn by the step's generator, every grid cell of those views a
target ray, whole chunks of ``ray_batch_size`` rays), the encoder with
BatchNorm on the batch's statistics, the YOLO render, the four-part
detection loss per chunk (the gradient of their sum), Adam."""

from __future__ import annotations

import numpy as np
import torch

from .render import iou, render_yolo


def rays_yolo(w2c, width, height, focal, c, near, far):
    """Rays of a grid of width x height cells: pixel centres at +0.49,
    directions K^-1 [u, v, 1] turned into the world (not normalized),
    origins the camera centres.  w2c (V, 4, 4) -> (V, H, W, 8) f32."""
    w2c = np.asarray(w2c, np.float32)
    f = np.asarray(focal, np.float32).reshape(-1)
    cc = np.asarray(c, np.float32).reshape(-1)
    K = np.array([[f[0], 0, cc[0]], [0, f[-1], cc[-1]], [0, 0, 1]],
                 np.float32)
    X, Y = np.meshgrid(np.arange(width, dtype=np.float32) + 0.49,
                       np.arange(height, dtype=np.float32) + 0.49,
                       indexing="xy")
    pix = np.stack([X, Y, np.ones_like(X)], -1)
    d_cam = np.einsum("ij,hwj->hwi", np.linalg.inv(K), pix)
    inv = np.linalg.inv(w2c)
    d = np.einsum("bij,hwj->bhwi", inv[:, :3, :3], d_cam)
    V = w2c.shape[0]
    o = np.broadcast_to(inv[:, None, None, :3, 3], (V, height, width, 3))
    nf = np.broadcast_to(np.array([near, far], np.float32),
                         (V, height, width, 2))
    return np.concatenate([o, d, nf], -1).astype(np.float32)


def _bce(p, t):
    return -(t * torch.clamp(torch.log(p), min=-100.0)
             + (1 - t) * torch.clamp(torch.log(1 - p), min=-100.0))


def _masked_mean(v, mask):
    n = mask.sum()
    s = torch.where(mask, v, torch.zeros_like(v)).sum()
    return torch.where(n > 0, s / torch.clamp(n, min=1), torch.zeros_like(s))


def yolo_loss(pred, target, anchors, w):
    """pred (R, A, 7), target (R, A, 6) [prob, x, y, w, h, class] with
    prob -1 ignored; w the weights of box, object, no-object, class.
    -> (total, box, object, no_object, class)"""
    obj, no_obj = target[..., 0] == 1, target[..., 0] == 0
    anc = anchors.reshape(1, -1, 2)
    no_object = _masked_mean(_bce(pred[..., 0], 0.0 * target[..., 0]),
                             no_obj)
    box = torch.cat([torch.sigmoid(pred[..., 1:3]),
                     torch.exp(pred[..., 3:5]) * anc], -1)
    ious = iou(box, target[..., 1:5]).detach()
    obj_loss = _masked_mean((pred[..., 0] - ious * target[..., 0]) ** 2, obj)
    pb = torch.cat([torch.sigmoid(pred[..., 1:3]), pred[..., 3:5]], -1)
    tb = torch.cat([target[..., 1:3],
                    torch.log(1e-6 + target[..., 3:5] / anc)], -1)
    box_loss = _masked_mean(((pb - tb) ** 2).mean(-1), obj)
    ce = -torch.gather(torch.log_softmax(pred[..., 5:], -1), -1,
                       target[..., 5:6].long())[..., 0]
    cls_loss = _masked_mean(ce, obj)
    total = (box_loss * w["box_loss"] + obj_loss * w["object_loss"]
             + no_object * w["no_object_loss"] + cls_loss * w["class_loss"])
    return total, box_loss, obj_loss, no_object, cls_loss


def yolo_batch(scene, rng, ns, cell, R, near, far):
    """The step's inputs from one scene {images (V, 3, H, W), poses (V, 4,
    4) world-to-camera, focal (2,), c (2,), targets (V, h, w, A, 6)}: the
    source views rng draws (as the trainer draws them: a count, then the
    views) and their cells' rays and targets, padded to whole chunks."""
    V, _, H, W = scene["images"].shape
    rng.integers(0, 1)
    sel = rng.choice(V, ns, replace=False)
    rays = rays_yolo(scene["poses"][sel], W // cell, H // cell,
                     scene["focal"] / cell, scene["c"] / cell, near,
                     far).reshape(-1, 8)
    A = scene["targets"].shape[-2]
    tgt = scene["targets"][sel].reshape(-1, A, 6)
    pad = (-rays.shape[0]) % R
    if pad:
        rays = np.concatenate([rays, np.repeat(rays[:1], pad, 0)])
        t = np.zeros((pad, A, 6), np.float32)
        t[..., 0] = -1
        tgt = np.concatenate([tgt, t])
    return sel, rays, tgt


def yolo_step(model, opt, scene, sel, rays, tgt, u, cfg, device):
    """One update; returns the mean total loss over the chunks."""
    y = cfg["yolo"]
    R, A = y["ray_batch_size"], len(y["anchors"][0])
    dev = device
    cond = model.encode(
        torch.as_tensor(scene["images"][sel][None], device=dev),
        torch.as_tensor(scene["poses"][sel][None], device=dev),
        torch.as_tensor(scene["focal"][None], device=dev),
        torch.as_tensor(scene["c"][None], device=dev), train=True)
    out = render_yolo(model, cond, torch.as_tensor(rays[None], device=dev),
                      torch.as_tensor(u, device=dev), A)
    out = out.reshape(-1, R, A, 7)
    tgt = torch.as_tensor(tgt, device=dev).reshape(-1, R, A, 6)
    anchors = torch.as_tensor(np.asarray(y["anchors"][0], np.float32),
                              device=dev)
    totals = torch.stack([yolo_loss(out[i], tgt[i], anchors, y["weights"])[0]
                          for i in range(out.shape[0])])
    opt.zero_grad(set_to_none=True)
    totals.sum().backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    opt.step()
    return float(totals.detach().mean()), grads
