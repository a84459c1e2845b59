"""mAP@IoU for the detection eval.

A copy of pixelnerf_yolo_tpu/detect/map.py (pure numpy).

Neither the reference nor its fork computes mAP — only P/R/F1 at a single
confidence point (the reference's util.py:765-805).  The
detection north star ("mAP@0.5 within 0.5 pt") needs the full
precision-recall sweep, so this module adds the standard VOC2010-style
all-point-interpolated AP on top of the same box representation
([class, score, x, y, w, h], centers+wh normalized to [0, 1]) and the
same host IoU (detect.boxes.iou == util.py:576-629).

Protocol (standard, documented divergences from the F1 path):
  * predictions and GT pass PER-CLASS NMS at the configured nms_iou,
    predictions with a ~0 confidence floor (the F1 path runs the
    reference's class-agnostic NMS and cuts at yolo.nms_threshold, which
    would suppress overlapping objects of different classes and truncate
    the PR curve);
  * matching is per-class greedy by descending score, one GT matched at
    most once, IoU > iou_threshold (the F1 path matches class-agnostically
    and lets one GT satisfy several predictions, util.py:779-787);
  * AP = area under the interpolated PR curve; mAP = mean over classes
    that appear in the GT.
"""

from __future__ import annotations

import numpy as np

from .boxes import iou


def _greedy_nms(rows: np.ndarray, nms_iou: float) -> np.ndarray:
    """STANDARD greedy NMS on (N, 6) [cls, score, x, y, w, h] rows of one
    class: descending score, a kept box suppresses every overlapper.

    Deliberately NOT detect.boxes.nms — that reproduces the reference's
    remove-while-iterating skip quirk (util.py:691-720), which fails to
    suppress every other duplicate when 3+ boxes coincide (e.g. the GT
    decode's one-row-per-scale duplicates under num_scales > 1), which
    would inflate n_gt and deflate AP.  The mAP path is documented as the
    standard protocol, so it gets the standard NMS.
    """
    order = np.argsort(-rows[:, 1], kind="stable")
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        rest = order[1:]
        ious = np.asarray(
            iou(rows[i, 2:6], rows[rest][:, 2:6])
        ).reshape(-1)
        order = rest[ious <= nms_iou]
    return rows[np.asarray(keep, np.int64)]


def _per_class_nms(raw_boxes, nms_iou: float, score_floor: float):
    """NMS each class independently (a class-agnostic pass would suppress
    an overlapping box of a *different* class)."""
    if len(raw_boxes) == 0:
        return np.zeros((0, 6), np.float64)
    rows = np.asarray(
        [[float(v) for v in b[:6]] for b in raw_boxes], np.float64
    )
    rows = rows[rows[:, 1] > score_floor]
    # same degenerate-size filter as the F1 path (util.py:703-706)
    ok = ((rows[:, 4] > 1e-3) & (rows[:, 4] < 1e4)
          & (rows[:, 5] > 1e-3) & (rows[:, 5] < 1e4))
    rows = rows[ok]
    if not len(rows):
        return np.zeros((0, 6), np.float64)
    kept = [
        _greedy_nms(rows[rows[:, 0].astype(np.int64) == cls], nms_iou)
        for cls in np.unique(rows[:, 0].astype(np.int64))
    ]
    return np.concatenate(kept) if kept else np.zeros((0, 6), np.float64)


def match_image_detections(
    gt_boxes,
    pred_boxes,
    iou_threshold: float = 0.5,
):
    """Greedy per-class matching for one image.

    :param gt_boxes list of [class, score, x, y, w, h] ground-truth rows
      (already deduplicated / NMS'd)
    :param pred_boxes list of [class, score, x, y, w, h] predictions
      (already NMS'd, any confidence)
    :return list of (class, score, is_tp) for every prediction, plus a
      {class: n_gt} count dict
    """
    gt = np.asarray(
        [[float(v) for v in b[:6]] for b in gt_boxes], np.float64
    ).reshape(-1, 6)
    preds = np.asarray(
        [[float(v) for v in b[:6]] for b in pred_boxes], np.float64
    ).reshape(-1, 6)
    preds = preds[np.argsort(-preds[:, 1], kind="stable")]
    n_gt: dict[int, int] = {}
    for c in gt[:, 0].astype(np.int64):
        n_gt[int(c)] = n_gt.get(int(c), 0) + 1

    # one broadcast IoU matrix instead of a per-pair python loop
    # (boxes.iou broadcasts; the greedy argmax then runs over rows)
    if len(preds) and len(gt):
        iou_mat = np.asarray(
            iou(preds[:, None, 2:6], gt[None, :, 2:6])
        ).reshape(len(preds), len(gt))
        cls_ok = (preds[:, 0].astype(np.int64)[:, None]
                  == gt[:, 0].astype(np.int64)[None, :])
        iou_mat = np.where(cls_ok, iou_mat, 0.0)
    else:
        iou_mat = np.zeros((len(preds), len(gt)))

    gt_used = np.zeros(len(gt), bool)
    records = []
    for i, p in enumerate(preds):
        row = np.where(gt_used, 0.0, iou_mat[i])
        best_j = int(np.argmax(row)) if len(gt) else -1
        best_iou = float(row[best_j]) if len(gt) else 0.0
        is_tp = best_iou > iou_threshold
        if is_tp:
            gt_used[best_j] = True
        records.append((int(p[0]), float(p[1]), is_tp))
    return records, n_gt


def average_precision(scores, tp_flags, n_gt: int) -> float:
    """All-point-interpolated AP for one class.

    :param scores (N,) prediction confidences (any order)
    :param tp_flags (N,) bools
    :param n_gt number of ground-truth boxes of this class
    """
    if n_gt == 0:
        return 0.0
    scores = np.asarray(scores, dtype=np.float64)
    tp = np.asarray(tp_flags, dtype=np.float64)
    if scores.size == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    tp = tp[order]
    fp = 1.0 - tp
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(fp)
    recall = cum_tp / n_gt
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1e-12)
    # envelope: precision at recall r = max precision at recall >= r
    mrec = np.concatenate([[0.0], recall, [recall[-1]]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def mean_average_precision(per_image_records, per_image_n_gt):
    """Aggregate per-image match records into (mAP, {class: AP}).

    :param per_image_records list (one per image) of lists of
      (class, score, is_tp)
    :param per_image_n_gt list (one per image) of {class: n_gt}
    """
    by_class: dict[int, list[tuple[float, bool]]] = {}
    gt_total: dict[int, int] = {}
    for recs in per_image_records:
        for cls, score, is_tp in recs:
            by_class.setdefault(cls, []).append((score, is_tp))
    for counts in per_image_n_gt:
        for cls, n in counts.items():
            gt_total[cls] = gt_total.get(cls, 0) + n
    aps = {}
    for cls, n in sorted(gt_total.items()):
        dets = by_class.get(cls, [])
        scores = [d[0] for d in dets]
        flags = [d[1] for d in dets]
        aps[cls] = average_precision(scores, flags, n)
    if not aps:
        return 0.0, {}
    return float(np.mean(list(aps.values()))), aps


def map_from_raw_boxes(
    per_image_gt,
    per_image_pred,
    nms_iou: float,
    iou_threshold: float = 0.5,
    nms_score_floor: float = 1e-3,
):
    """mAP@iou_threshold from raw decoded boxes (pre-NMS).

    :param per_image_gt/per_image_pred lists (one per image) of raw
      [class, score, x, y, w, h] box lists as produced by
      convert_cells_to_bboxes
    :return (mAP, {class: AP})
    """
    records, counts = [], []
    for gt_raw, pred_raw in zip(per_image_gt, per_image_pred):
        # GT decode emits one row per assigned (cell, anchor); dedup those
        # multi-anchor duplicates per class, and NMS predictions per class
        # too — a joint class-agnostic pass would undercount n_gt (or drop
        # a correct detection) whenever objects of different classes
        # overlap above nms_iou.
        gt_nms = _per_class_nms(gt_raw, nms_iou, 0.5)
        pred_nms = _per_class_nms(pred_raw, nms_iou, nms_score_floor)
        recs, n_gt = match_image_detections(
            gt_nms, pred_nms, iou_threshold
        )
        records.append(recs)
        counts.append(n_gt)
    return mean_average_precision(records, counts)
