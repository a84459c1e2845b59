"""Padded greedy NMS, cell decode and TP/FP/FN on the device.

Counterpart of pixelnerf_yolo_tpu/detect/nms_jax.py, in plain torch on the
boxes' device with static shapes: boxes are padded, suppressed by mask,
and the greedy loop runs up to ``max_out`` rounds of vectorized IoU tests,
stopping once no box is left.  It is *standard* greedy NMS; the
reference's list NMS (``boxes.nms``) keeps its remove-while-iterating
quirk and can keep extra boxes.
"""

from __future__ import annotations

import torch

from ..losses.yolo import iou_xywh
from ..utils.profiling import count, scope

# rounds of the greedy loop between two looks (one host sync) at whether
# any box is left
STOP_CHECK = 32


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
