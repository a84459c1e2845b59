"""The reference's renderers, decode and suppression.

NeRF: stratified coarse samples, alpha compositing, importance samples
from the coarse weights plus Gaussian samples around the coarse depth,
the fine field evaluated over the sorted union and composited.  YOLO:
stratified samples, the field's seven values per anchor, and per ray the
objectness max over the samples and the values weighted by objectness.
Every random number comes in as a draw (the benchmark makes them).
"""

from __future__ import annotations

import torch


def lerp_depth(rays, t):
    near, far = rays[:, 6:7], rays[:, 7:8]
    return near * (1.0 - t) + far * t


def sample_coarse(rays, k, u):
    steps = torch.arange(k, dtype=torch.float32, device=rays.device) / k
    return lerp_depth(rays, steps[None] + u / k)


def sample_fine(rays, weights, k_coarse, u, u_jitter):
    """Inverse CDF of the coarse weights by comparison count."""
    w = weights.detach() + 1e-5
    cdf = torch.cumsum(w / w.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)
    inds = (cdf[:, :, None] <= u[:, None, :]).sum(1).float()
    inds = torch.clamp(inds - 1.0, min=0.0)
    return lerp_depth(rays, (inds + u_jitter) / k_coarse)


def composite(rgb_sigma, z, far, white_bkgd):
    deltas = torch.cat([z[:, 1:] - z[:, :-1], far - z[:, -1:]], -1)
    alpha = 1.0 - torch.exp(-deltas * torch.relu(rgb_sigma[..., 3]))
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                     1.0 - alpha + 1e-10], -1), -1)
    w = alpha * trans[:, :-1]
    rgb = (w[..., None] * rgb_sigma[..., :3]).sum(1)
    if white_bkgd:
        rgb = rgb + (1.0 - w.sum(-1))[:, None]
    return w, rgb, (w * z).sum(-1)


def field_along(model, cond, rays, z, coarse):
    """The field at depths z (B, K) along rays (B, 8) -> (B, K, d_out)."""
    pts = rays[:, None, :3] + z[..., None] * rays[:, None, 3:6]
    dirs = rays[:, None, 3:6].expand_as(pts)
    return model(cond, pts.reshape(1, -1, 3), dirs.reshape(1, -1, 3),
                 coarse=coarse).reshape(z.shape[0], z.shape[1], -1)


def coarse_pass(model, cond, rays, draws, r):
    """(weights, rgb, depth) of the coarse pass over rays (B, 8)."""
    z_c = sample_coarse(rays, r["n_coarse"], draws["u_coarse"])
    return composite(field_along(model, cond, rays, z_c, True), z_c,
                     rays[:, 7:8], r["white_bkgd"])


def fine_pass(model, cond, rays, draws, r, w_c, depth_c):
    """(rgb, depth) of the fine pass at the samples that the coarse
    weights and depth place: the coarse samples, importance samples of
    the weights and Gaussian samples around the depth, sorted."""
    far = rays[:, 7:8]
    z_c = sample_coarse(rays, r["n_coarse"], draws["u_coarse"])
    z_f = sample_fine(rays, w_c, r["n_coarse"], draws["u"],
                      draws["u_jitter"])
    z_d = depth_c[:, None] + draws["noise_d"] * r["depth_std"]
    z_d = torch.maximum(torch.minimum(z_d, far), rays[:, 6:7])
    z_u = torch.sort(torch.cat([z_c, z_f, z_d], -1), dim=-1,
                     stable=True).values
    _, rgb, depth = composite(field_along(model, cond, rays, z_u, False),
                              z_u, far, r["white_bkgd"])
    return rgb, depth


def render_nerf(model, cond, rays, draws, r):
    """rays (B, 8) of one scene; draws {u_coarse, u, u_jitter, noise_d}
    over the B rays; r the renderer settings.  -> {coarse, fine} each
    {rgb (B, 3), depth (B,)}"""
    w_c, rgb_c, depth_c = coarse_pass(model, cond, rays, draws, r)
    rgb_f, depth_f = fine_pass(model, cond, rays, draws, r, w_c, depth_c)
    return {"coarse": {"rgb": rgb_c, "depth": depth_c},
            "fine": {"rgb": rgb_f, "depth": depth_f}}


def render_yolo(model, cond, rays, u, n_anchors):
    """rays (SB, B, 8), u (SB * B, K) -> (SB, B, A, 7) = [objectness,
    x, y, w, h, c0, c1]"""
    SB, B = rays.shape[:2]
    flat = rays.reshape(-1, 8)
    z = sample_coarse(flat, u.shape[1], u)
    pts = flat[:, None, :3] + z[..., None] * flat[:, None, 3:6]
    dirs = flat[:, None, 3:6].expand_as(pts)
    K = u.shape[1]
    out = model(cond, pts.reshape(SB, B * K, 3), dirs.reshape(SB, B * K, 3))
    out = out.reshape(SB * B, K, n_anchors, 7)
    p = torch.sigmoid(out[..., 0])
    vals = (out[..., 1:] * p[..., None]).sum(1) / (p.sum(1)[..., None]
                                                   + 1e-5)
    return torch.cat([p.amax(1)[..., None], vals], -1).reshape(
        SB, B, n_anchors, 7)


def decode(pred, anchors):
    """(h, w, A, 7) -> (h * w * A, 6) rows [class, score, x, y, w, h] in
    fractions of the view."""
    h, w, A = pred.shape[:3]
    anc = torch.as_tensor(anchors, dtype=torch.float32,
                          device=pred.device).reshape(1, 1, A, 2)
    xy = torch.sigmoid(pred[..., 1:3])
    wh = torch.exp(pred[..., 3:5]) * anc
    cls = torch.argmax(pred[..., 5:], -1).float()
    cx = torch.arange(w, device=pred.device, dtype=torch.float32)
    cy = torch.arange(h, device=pred.device, dtype=torch.float32)
    x = (xy[..., 0] + cx[None, :, None]) / w
    y = (xy[..., 1] + cy[:, None, None]) / h
    out = torch.stack([cls, pred[..., 0], x, y, wh[..., 0] / w,
                       wh[..., 1] / h], -1)
    return out.reshape(-1, 6)


def iou(a, b):
    """IoU of center-format [x, y, w, h] boxes, broadcasting."""
    a1, a2 = a[..., :2] - a[..., 2:4] / 2, a[..., :2] + a[..., 2:4] / 2
    b1, b2 = b[..., :2] - b[..., 2:4] / 2, b[..., :2] + b[..., 2:4] / 2
    wh = torch.clamp(torch.minimum(a2, b2) - torch.maximum(a1, b1), min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = torch.abs((a2[..., 0] - a1[..., 0]) * (a2[..., 1] - a1[..., 1]))
    area_b = torch.abs((b2[..., 0] - b1[..., 0]) * (b2[..., 1] - b1[..., 1]))
    return inter / (area_a + area_b - inter + 1e-6)


def nms(boxes, iou_threshold, score_threshold, max_out=64):
    """Greedy NMS: among boxes above the score threshold with sane sizes,
    keep the highest (the first of equal scores), drop those that overlap
    it by more than iou_threshold, repeat.  -> the kept rows, in order."""
    return boxes[nms_index(boxes, iou_threshold, score_threshold, max_out)]


def nms_index(boxes, iou_threshold, score_threshold, max_out=64):
    """``nms``'s kept rows as indices into boxes."""
    wh = boxes[:, 4:6]
    ok = (boxes[:, 1] > score_threshold) & (wh > 1e-3).all(1) & (
        wh < 1e5).all(1)
    idx = torch.nonzero(ok)[:, 0].tolist()
    idx.sort(key=lambda i: (-float(boxes[i, 1]), i))
    kept = []
    while idx and len(kept) < max_out:
        best = idx.pop(0)
        kept.append(best)
        if idx:
            ov = iou(boxes[best, 2:6][None], boxes[idx, 2:6])
            idx = [i for i, o in zip(idx, ov.tolist()) if o <= iou_threshold]
    return torch.tensor(kept, dtype=torch.long, device=boxes.device)
