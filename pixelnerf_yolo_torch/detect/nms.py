"""Padded greedy NMS, cell decode (one grid or several), the cross-scale
pass and TP/FP/FN on the device.

Counterpart of pixelnerf_yolo_tpu/detect/nms_jax.py, in plain torch on the
boxes' device with static shapes: boxes are padded, suppressed by mask,
and the greedy loop runs up to ``max_out`` rounds of vectorized IoU tests,
stopping once no box is left.  It is *standard* greedy NMS; the
reference's list NMS (``boxes.nms``) keeps its remove-while-iterating
quirk and can keep extra boxes.  ``decode_scales`` and
``cross_scale_padded`` have no counterpart there: the JAX package runs the
multi-scale chain on the host lists (``boxes.suppress_cross_scale``).
"""

from __future__ import annotations

import torch

from ..losses.yolo import iou_xywh
from ..utils.profiling import count, scope

# rounds of the greedy loop between two looks (one host sync) at whether
# any box is left
STOP_CHECK = 32
# rounds of the cross-scale pass between two looks at whether it settled
XSCALE_CHECK = 4


def nms_padded(boxes: torch.Tensor, iou_threshold: float,
               score_threshold: float, max_out: int = 64):
    """Greedy NMS over padded boxes.

    :param boxes (N, 6) rows [class, score, x, y, w, h]; padding rows must
      have score <= score_threshold
    :return (kept (max_out, 6), valid (max_out,) bool); with no boxes
      (N = 0) nothing is kept (the JAX package's nms_padded raises there)

    The rounds the loop ran count as ``nms_rounds`` (utils/profiling.py).
    """
    with scope("nms_padded"):
        n = boxes.shape[0]
        dev = boxes.device
        if n == 0:
            return (boxes.new_zeros((max_out, 6)),
                    torch.zeros(max_out, dtype=torch.bool, device=dev))
        scores = boxes[:, 1]
        wh_ok = ((boxes[:, 4] > 10e-4) & (boxes[:, 4] < 10e4)
                 & (boxes[:, 5] > 10e-4) & (boxes[:, 5] < 10e4))
        alive = (scores > score_threshold) & wh_ok
        ious = iou_xywh(boxes[:, None, 2:6], boxes[None, :, 2:6])  # (N, N)
        arange = torch.arange(n, device=dev)
        neg_inf = torch.tensor(-float("inf"), dtype=scores.dtype, device=dev)
        kept_idx = torch.zeros(max_out, dtype=torch.long, device=dev)
        kept_valid = torch.zeros(max_out, dtype=torch.bool, device=dev)
        rounds = 0
        for step in range(max_out):
            # once no box is alive every later round keeps nothing (row 0,
            # invalid): stop there, looking every STOP_CHECK rounds
            if step % STOP_CHECK == 0 and not bool(alive.any()):
                break
            rounds += 1
            masked = torch.where(alive, scores, neg_inf)
            best = torch.argmax(masked)
            valid = masked[best] > neg_inf
            kept_idx[step] = torch.where(valid, best, 0)
            kept_valid[step] = valid
            suppress = (ious[best] > iou_threshold) | (arange == best)
            alive = alive & (~suppress | ~valid)
        count("nms_rounds", rounds)
        return boxes[kept_idx], kept_valid


def decode_cells(predictions: torch.Tensor, anchors: torch.Tensor,
                 is_predictions: bool = True) -> torch.Tensor:
    """Grid-cell decode (``convert_cells_to_bboxes`` semantics, the same
    (h, w, a) flattening order).

    :param predictions (B, h, w, A, 6|7); anchors (A, 2)
    :return (B, h*w*A, 6) rows [class, score, x, y, w, h]
    """
    with scope("decode_cells"):
        B, h, w, A = predictions.shape[:4]
        dt, dev = predictions.dtype, predictions.device
        box = predictions[..., 1:5]
        scores = predictions[..., 0:1]
        if is_predictions:
            anc = torch.as_tensor(anchors, dtype=dt, device=dev).reshape(
                1, 1, 1, A, 2)
            xy = torch.sigmoid(box[..., 0:2])
            wh = torch.exp(box[..., 2:4]) * anc
            best_class = torch.argmax(predictions[..., 5:], dim=-1)[
                ..., None].to(dt)
        else:
            xy = box[..., 0:2]
            wh = box[..., 2:4]
            best_class = predictions[..., 5:6]
        cell_x = torch.arange(w, dtype=dt, device=dev)[
            None, None, :, None, None]
        cell_y = torch.arange(h, dtype=dt, device=dev)[
            None, :, None, None, None]
        x = (xy[..., 0:1] + cell_x) / w
        y = (xy[..., 1:2] + cell_y) / h
        wh = wh / torch.tensor([w, h], dtype=dt, device=dev)
        out = torch.cat([best_class, scores, x, y, wh], dim=-1)
        return out.reshape(B, h * w * A, 6)


def decode_scales(predictions: torch.Tensor, grids, anchors: torch.Tensor):
    """``decode_cells`` over the rays of several grids rendered in one
    batch (``utils.camera.gen_rays_yolo_scales``): each grid with its own
    anchors, the rows scale by scale and then (h, w, a), as the trainer's
    host lists give them.

    :param predictions (B, N, A, 6|7), grid s's rays after grid s-1's
    :param grids [(h, w)] of each scale; anchors (S, A, 2)
    :return (boxes (B, N*A, 6) [class, score, x, y, w, h], scale (N*A,)
      the scale of each row)
    """
    B, _, A = predictions.shape[:3]
    dev = predictions.device
    boxes, scale, at = [], [], 0
    for s, (h, w) in enumerate(grids):
        cells = predictions[:, at:at + h * w].reshape(B, h, w, A, -1)
        boxes.append(decode_cells(cells, anchors[s]))
        scale.append(torch.full((h * w * A,), s, dtype=torch.long,
                                device=dev))
        at += h * w
    return torch.cat(boxes, dim=1), torch.cat(scale)


def cross_scale_padded(boxes: torch.Tensor, scale: torch.Tensor,
                       cross_iou: float, score_threshold: float,
                       floors=None) -> torch.Tensor:
    """Cross-scale duplicate suppression on the device: the padded twin of
    ``boxes.suppress_cross_scale`` as the trainer's chain runs it (after
    ``_filter_scales``' per-scale floors, before NMS).

    A row enters when its score passes score_threshold and, with floors,
    is at or above its scale's floor.  Leaving the rest out changes no
    kept box: a box at or below the threshold can suppress only boxes that
    rank after it, which NMS drops too.  Sizes are not looked at, so a box
    that NMS will refuse for its size still suppresses, as on the host.
    Greedy by descending score (the first of equal scores first), a kept
    row removes every later row of the same class from another scale at
    IoU > cross_iou (IoUs in float64, as the host's).  The greedy pass is
    the fixed point of kept[j] = no kept earlier row removes j, reached by
    whole-vector rounds (at most M + 1) with a look (one sync) at the
    first and every ``XSCALE_CHECK``-th; the filter's row count is one
    more sync.

    :param boxes (N, 6) [class, score, x, y, w, h]; scale (N,) int
    :param floors per-scale score floors (``yolo.nms_threshold_per_scale``)
      or None
    :return (M, 6) the entering rows in descending score order, the removed
      ones with score -inf: padded boxes for ``nms_padded``

    The rows that enter count as ``xscale_in``, the rows it removes as
    ``xscale_dropped`` (utils/profiling.py).
    """
    with scope("cross_scale_padded"):
        scores = boxes[:, 1]
        enter = scores > score_threshold
        if floors is not None:
            floor = torch.as_tensor(floors, dtype=scores.dtype,
                                    device=boxes.device)
            enter = enter & (scores >= floor[scale])
        idx = torch.nonzero(enter).squeeze(1)
        order = torch.sort(scores[idx], descending=True, stable=True).indices
        idx = idx[order]
        rows, sc = boxes[idx], scale[idx]
        m = rows.shape[0]
        count("xscale_in", m)
        if m == 0 or cross_iou <= 0:  # 0: the pass is off
            count("xscale_dropped", 0)
            return rows
        b = rows.double()
        dup = ((iou_xywh(b[:, None, 2:6], b[None, :, 2:6]) > cross_iou)
               & (sc[:, None] != sc[None, :])
               & (b[:, None, 0] == b[None, :, 0])).triu(1)
        # dup[i, j]: i ranks before j and removes it if i is kept
        kept = torch.ones(m, dtype=torch.bool, device=boxes.device)
        for step in range(m + 1):
            nxt = ~(dup & kept[:, None]).any(0)
            if step % XSCALE_CHECK == 0 or step == m:
                still, n_kept = torch.stack(
                    [(nxt != kept).any().long(), nxt.sum()]).tolist()
                if not still:
                    break
            kept = nxt
        count("xscale_dropped", m - n_kept)
        neg_inf = torch.full_like(rows[:, 1], -float("inf"))
        return torch.cat([rows[:, :1],
                          torch.where(kept, rows[:, 1], neg_inf)[:, None],
                          rows[:, 2:]], dim=1)


def tp_fp_fn_padded(target_boxes: torch.Tensor, pred_boxes: torch.Tensor,
                    nms_iou: float, nms_t: float, match_iou: float,
                    max_out: int = 64):
    """Device TP/FP/FN: NMS both padded sets, then the matching of
    ``boxes.calculate_tp_fp_fn``: tp when a prediction's best target IoU >
    match_iou, fn when a target's best prediction IoU < match_iou; no
    targets -> every prediction fp; no predictions -> every target fn.

    :param target_boxes, pred_boxes (N, 6) [class, score, x, y, w, h]
    :return (tp, fp, fn) int64 scalar tensors
    """
    t_kept, t_valid = nms_padded(target_boxes, nms_iou, nms_t, max_out)
    p_kept, p_valid = nms_padded(pred_boxes, nms_iou, nms_t, max_out)
    n_t, n_p = t_valid.sum(), p_valid.sum()
    ious = iou_xywh(p_kept[:, None, 2:6], t_kept[None, :, 2:6])  # (P, T)
    neg_inf = torch.full_like(ious, -float("inf"))
    best_per_pred = torch.where(t_valid[None, :], ious, neg_inf).amax(dim=1)
    best_per_target = torch.where(p_valid[:, None], ious, neg_inf).amax(dim=0)
    hit = best_per_pred > match_iou
    tp = (p_valid & hit).sum()
    fp = (p_valid & ~hit).sum()
    fn = (t_valid & (best_per_target < match_iou)).sum()
    zero = torch.zeros_like(tp)
    empty_t, empty_p = n_t == 0, n_p == 0
    tp = torch.where(empty_t | empty_p, zero, tp)
    fp = torch.where(empty_t, n_p, torch.where(empty_p, zero, fp))
    fn = torch.where(empty_t, zero, torch.where(empty_p, n_t, fn))
    return tp, fp, fn
