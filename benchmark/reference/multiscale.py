"""The reference's multi-scale detection: YOLOv3's three grids (Redmon &
Farhadi 2018, arXiv:1804.02767: strides 32, 16 and 8, three anchors a
grid, the large anchors on the coarse grid) over NeRF-YOLO's ray field.
The cell rays of every grid of the destination view, the field rendered
along each (``render.render_yolo``, in blocks of rays), each grid decoded
with its own anchors (``render.decode``), the cross-scale pass, and NMS
(``render.nms_index``).

Departures from the published description:

- One field for every grid: YOLOv3 has a head per scale; NeRF-YOLO's
  model has one, and a grid differs only in its rays and its anchors (the
  repository's three-scale recipe, ``conf/exp/yolo_3scale.conf``).
- Before NMS, a cross-scale pass: greedy by descending score, a kept box
  removes every later box of the same class from another grid at IoU
  above ``cross_iou`` (the repository's extension; YOLOv3 runs one NMS
  over every grid's boxes).  Only boxes whose score passes the NMS
  threshold (and their grid's floor, where floors are given) enter it: a
  box at or below the threshold removes only boxes that rank after it,
  which NMS drops anyway.  Sizes are not looked at there.
- The reference implementation's conventions, as ``render.decode`` has
  them: pixel centres at +0.49 of a cell, directions K^-1 [u, v, 1] not
  normalized, anchors in cell units over the grid.
"""

from __future__ import annotations

import torch

from .render import decode, iou, nms_index, render_yolo


def grid_rays(w2c, size: int, focal: float, cell_sizes, near: float,
              far: float):
    """(rays (N, 8) of every grid of a square view, grid by grid, each in
    (h, w) order; [(h, w)] of each grid).  w2c (4, 4) world-to-camera;
    focal in pixels, the principal point at the centre."""
    dev = w2c.device
    inv = torch.linalg.inv(w2c.double())
    parts, grids = [], []
    for cs in cell_sizes:
        n = size // cs
        f, c = focal / cs, size / 2 / cs
        g = torch.arange(n, dtype=torch.float64, device=dev) + 0.49
        Y, X = torch.meshgrid(g, g, indexing="ij")
        d = torch.stack([(X - c) / f, (Y - c) / f, torch.ones_like(X)], -1)
        d = torch.einsum("ij,hwj->hwi", inv[:3, :3], d).reshape(-1, 3)
        nf = torch.tensor([near, far], dtype=torch.float64,
                          device=dev).expand(d.shape[0], 2)
        parts.append(torch.cat([inv[:3, 3].expand_as(d), d, nf], -1))
        grids.append((n, n))
    return torch.cat(parts).float(), grids


def render_grids(model, cond, rays, u, n_anchors: int, block: int):
    """(N, A, 7) of rays (N, 8) with draws u (N, K), ``block`` rays at a
    time (the answer does not depend on it)."""
    return torch.cat([
        render_yolo(model, cond, rays[None, s:s + block], u[s:s + block],
                    n_anchors)[0]
        for s in range(0, rays.shape[0], block)])


def decode_grids(out, grids, anchors):
    """(rows (N * A, 6) [class, score, x, y, w, h], grid (N * A,) of each
    row) of out (N, A, 7): grid by grid, then (h, w, a)."""
    rows, scale, at = [], [], 0
    for s, (h, w) in enumerate(grids):
        rows.append(decode(out[at:at + h * w].reshape(h, w, -1, 7),
                           anchors[s]))
        scale.append(torch.full((rows[-1].shape[0],), s, dtype=torch.long,
                                device=out.device))
        at += h * w
    return torch.cat(rows), torch.cat(scale)


def cross_scale(boxes, scale, cross_iou: float, threshold: float,
                floors=None):
    """Indices of the rows the cross-scale pass keeps, in descending score
    order (the first of equal scores first), in float64."""
    b = boxes.double()
    ok = b[:, 1] > threshold
    if floors is not None:
        ok &= b[:, 1] >= torch.as_tensor(floors, dtype=torch.float64,
                                         device=b.device)[scale]
    idx = torch.nonzero(ok)[:, 0].tolist()
    idx.sort(key=lambda i: (-float(b[i, 1]), i))
    if cross_iou <= 0:
        return torch.tensor(idx, dtype=torch.long, device=boxes.device)
    kept = []
    while idx:
        best = idx.pop(0)
        kept.append(best)
        if idx:
            rest = torch.tensor(idx, device=boxes.device)
            dup = ((iou(b[best, 2:6][None], b[rest, 2:6]) > cross_iou)
                   & (scale[rest] != scale[best])
                   & (b[rest, 0] == b[best, 0]))
            idx = [i for i, d in zip(idx, dup.tolist()) if not d]
    return torch.tensor(kept, dtype=torch.long, device=boxes.device)


def detect_index(boxes, scale, cross_iou: float, iou_threshold: float,
                 threshold: float, max_out: int = 64, floors=None):
    """Indices of the rows kept by the cross-scale pass and then NMS, in
    NMS's order."""
    keep = cross_scale(boxes, scale, cross_iou, threshold, floors)
    return keep[nms_index(boxes[keep], iou_threshold, threshold, max_out)]
