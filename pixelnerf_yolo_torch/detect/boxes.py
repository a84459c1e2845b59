"""Detection box ops: IoU, cell->bbox decode, NMS, TP/FP/FN matching.

A copy of pixelnerf_yolo_tpu/detect/boxes.py (numpy; cv2 only for the
drawing helper, imported where it draws).  Parity: the reference's util.py:576-805.  These are the
postprocessing ops of the YOLO pipeline.  The decode is vectorized numpy
(the reference builds python lists per cell); NMS and matching are
host-side like the reference, with the reference's exact greedy semantics —
including its remove-while-iterating behavior, which skips the element
after each removed box and therefore changes which boxes survive
(util.py:708-718).  A padded, jittable NMS for on-device use lives in
detect/nms.py.
"""

from __future__ import annotations

import numpy as np


def iou(box1: np.ndarray, box2: np.ndarray, is_pred: bool = True):
    """IoU of [x, y, w, h] center-format boxes (broadcasting), or
    width/height-only anchor IoU when is_pred=False.  util.py:576-629."""
    box1 = np.asarray(box1, dtype=np.float64)
    box2 = np.asarray(box2, dtype=np.float64)
    if is_pred:
        b1_x1 = box1[..., 0:1] - box1[..., 2:3] / 2
        b1_y1 = box1[..., 1:2] - box1[..., 3:4] / 2
        b1_x2 = box1[..., 0:1] + box1[..., 2:3] / 2
        b1_y2 = box1[..., 1:2] + box1[..., 3:4] / 2
        b2_x1 = box2[..., 0:1] - box2[..., 2:3] / 2
        b2_y1 = box2[..., 1:2] - box2[..., 3:4] / 2
        b2_x2 = box2[..., 0:1] + box2[..., 2:3] / 2
        b2_y2 = box2[..., 1:2] + box2[..., 3:4] / 2

        x1 = np.maximum(b1_x1, b2_x1)
        y1 = np.maximum(b1_y1, b2_y1)
        x2 = np.minimum(b1_x2, b2_x2)
        y2 = np.minimum(b1_y2, b2_y2)
        intersection = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
        box1_area = np.abs((b1_x2 - b1_x1) * (b1_y2 - b1_y1))
        box2_area = np.abs((b2_x2 - b2_x1) * (b2_y2 - b2_y1))
        union = box1_area + box2_area - intersection
        return intersection / (union + 1e-6)

    inter = np.minimum(box1[..., 0], box2[..., 0]) * np.minimum(
        box1[..., 1], box2[..., 1]
    )
    union = box1[..., 0] * box1[..., 1] + box2[..., 0] * box2[..., 1] - inter
    return inter / union


def convert_cells_to_bboxes(
    predictions: np.ndarray,
    anchors: np.ndarray,
    h: int,
    w: int,
    is_predictions: bool = True,
) -> list:
    """Decode grid-cell values to normalized boxes.

    :param predictions (B, h, w, A, 6 or 7)
    :param anchors (A, 2) normalized anchor w/h
    :return python list (B, A*h*w, 6) of [class, score, x, y, w, h]
    Parity: util.py:633-687 (vectorized; same (h, w, a) flattening order).
    """
    predictions = np.asarray(predictions, dtype=np.float32)
    anchors = np.asarray(anchors, dtype=np.float32)
    batch_size = predictions.shape[0]
    num_anchors = anchors.shape[0]
    box_predictions = predictions[..., 1:5].copy()

    if is_predictions:
        anc = anchors.reshape(1, 1, 1, num_anchors, 2)
        box_predictions[..., 0:2] = 1.0 / (
            1.0 + np.exp(-box_predictions[..., 0:2])
        )
        box_predictions[..., 2:] = np.exp(box_predictions[..., 2:]) * anc
        scores = predictions[..., 0:1]
        best_class = np.argmax(predictions[..., 5:], axis=-1)[..., None].astype(
            np.float32
        )
    else:
        scores = predictions[..., 0:1]
        best_class = predictions[..., 5:6]

    cell_x = np.broadcast_to(
        np.arange(w, dtype=np.float32)[None, None, :, None, None],
        box_predictions[..., 0:1].shape,
    )
    cell_y = np.broadcast_to(
        np.arange(h, dtype=np.float32)[None, :, None, None, None],
        box_predictions[..., 1:2].shape,
    )
    x = (box_predictions[..., 0:1] + cell_x) / w
    y = (box_predictions[..., 1:2] + cell_y) / h
    wh = box_predictions[..., 2:4] / np.array([w, h], dtype=np.float32)

    converted = np.concatenate([best_class, scores, x, y, wh], axis=-1)
    return converted.reshape(batch_size, num_anchors * h * w, 6).tolist()


def nms(bboxes: list, iou_threshold: float, threshold: float,
        allow_empty: bool = False):
    """Greedy list NMS with the reference's exact semantics.

    Returns (kept_boxes, highest_confidence, n_above_threshold).
    Parity: util.py:691-720 — including the remove-during-iteration
    behavior: after suppressing a box, the iteration skips the box that
    slid into its position, so some overlapping boxes can survive.

    allow_empty: the reference crashes on an empty box list (util.py:691
    ``max()`` of an empty sequence); pass True for a deliberate divergence
    that returns ([], 0.0, 0) so metric runs survive empty scenes.
    """
    if allow_empty and not bboxes:
        return [], 0.0, 0
    highest_confidence = max(box[1] for box in bboxes)
    bboxes_filtered = [box for box in bboxes if box[1] > threshold]
    bboxes_above_threshold = len(bboxes_filtered)
    bboxes_filtered = [
        box
        for box in bboxes_filtered
        if 10e-4 < box[4] < 10e4 and 10e-4 < box[5] < 10e4
    ]
    bboxes_filtered = sorted(bboxes_filtered, key=lambda x: x[1], reverse=True)

    bboxes_nms = []
    while bboxes_filtered:
        first_box = bboxes_filtered.pop(0)
        bboxes_nms.append(first_box)
        # faithful remove-while-iterating: index does not advance past the
        # element that replaces a removed one
        i = 0
        while i < len(bboxes_filtered):
            box = bboxes_filtered[i]
            score = iou(
                np.asarray(first_box[2:], dtype=np.float64),
                np.asarray(box[2:], dtype=np.float64),
            ).reshape(-1)[0]
            if score > iou_threshold:
                bboxes_filtered.pop(i)
                # removing advances the cursor over the shifted element,
                # exactly like list.remove inside a for-loop
                i += 1
            else:
                i += 1
    return bboxes_nms, highest_confidence, bboxes_above_threshold


def suppress_cross_scale(bboxes_per_scale: list, cross_iou: float) -> list:
    """Suppress cross-scale duplicate detections (framework extension).

    Under ``num_scales > 1`` one object is typically detected at EVERY
    grid resolution; the two boxes overlap at IoU ~0.4-0.7, below the
    reference's ``nms_iou_threshold`` (0.75, tuned for single-scale
    output), so standard NMS keeps both and precision collapses (measured:
    F1 0.629 with 105 cross-scale FPs on the first 2-scale hardware run —
    CONVERGENCE.md r4).  This pass runs BEFORE the standard NMS: greedy by
    descending confidence, a kept box suppresses a SAME-CLASS box from a
    DIFFERENT scale at IoU > cross_iou.  Same-scale pairs are never
    touched here (they belong to the standard NMS at its own threshold),
    so genuinely distinct overlapping objects within one grid survive.

    The reference defines multi-scale anchors but never exercises them
    (the reference's conf/exp/yolo.conf:20-34), so this knob has no
    reference counterpart; it is off unless ``yolo.cross_scale_nms_iou``
    is set (> 0).

    :param bboxes_per_scale list (one per scale) of [class, score, x, y,
      w, h] box lists as produced by convert_cells_to_bboxes
    :param cross_iou IoU above which a cross-scale same-class pair is a
      duplicate
    :return flat box list (floats), highest-confidence-first
    """
    flat = [b for sub in bboxes_per_scale for b in sub]
    if len(bboxes_per_scale) <= 1 or cross_iou <= 0 or not flat:
        return flat
    rows = np.asarray([[float(v) for v in b[:6]] for b in flat], np.float64)
    scales = np.concatenate([
        np.full(len(sub), s, np.int64)
        for s, sub in enumerate(bboxes_per_scale)
    ])
    order = np.argsort(-rows[:, 1], kind="stable")
    rows, scales = rows[order], scales[order]
    alive = np.ones(len(rows), bool)
    idx = np.arange(len(rows))
    for i in range(len(rows)):
        if not alive[i]:
            continue
        rest = idx[alive & (idx > i)]
        if not rest.size:
            break
        ious = np.asarray(iou(rows[i, 2:6], rows[rest][:, 2:6])).reshape(-1)
        dup = (
            (scales[rest] != scales[i])
            & (rows[rest][:, 0] == rows[i, 0])
            & (ious > cross_iou)
        )
        alive[rest[dup]] = False
    return rows[alive].tolist()


def calculate_tp_fp_fn(
    target_bboxes: list,
    prediction_bboxes: list,
    nms_iou: float,
    nms_t: float,
    match_iou: float,
    print_hc: bool = False,
):
    """NMS both sets, then greedy IoU matching.  Parity: util.py:765-797
    (empty inputs survive via nms(allow_empty=True) — see its docstring)."""
    target_nms, _, _ = nms(target_bboxes, nms_iou, nms_t, allow_empty=True)
    pred_nms, hc, _ = nms(
        prediction_bboxes, nms_iou, nms_t, allow_empty=True
    )
    if print_hc:
        print(f"highest confidence: {hc}")

    tp = fp = fn = 0
    if len(target_nms) == 0:
        return 0, len(pred_nms), 0
    if len(pred_nms) == 0:
        return 0, 0, len(target_nms)

    for pred in pred_nms:
        scores = [
            iou(np.asarray(pred[2:]), np.asarray(t[2:])).reshape(-1)[0]
            for t in target_nms
        ]
        if max(scores) > match_iou:
            tp += 1
        else:
            fp += 1
    for t in target_nms:
        scores = [
            iou(np.asarray(t[2:]), np.asarray(p[2:])).reshape(-1)[0]
            for p in pred_nms
        ]
        if max(scores) < match_iou:
            fn += 1
    return tp, fp, fn


def calculate_precision_recall_f1(tp: int, fp: int, fn: int):
    """Parity: util.py:800-805."""
    precision = tp / (tp + fp) if tp + fp > 0 else 0
    recall = tp / (tp + fn) if tp + fn > 0 else 0
    f1 = (
        2 * (precision * recall) / (precision + recall)
        if precision + recall > 0
        else 0
    )
    return precision, recall, f1


def draw_bounding_boxes(image: np.ndarray, boxes: list) -> np.ndarray:
    """Draw class-colored boxes and labels (needs cv2)."""
    import cv2

    colors = [(1.0, 0.48, 0.0), (0.0, 0.79, 0.14)]
    class_names = ["Human", "Car"]
    img = np.array(image)
    h, w, _ = img.shape
    # cv2 >= 5 requires uint8 for text drawing; draw on a uint8 canvas and
    # return in the input's float [0,1] range like the reference
    was_float = np.issubdtype(img.dtype, np.floating)
    if was_float:
        output_image = np.ascontiguousarray(
            (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
        )
        colors = [tuple(int(c * 255) for c in col) for col in colors]
    else:
        output_image = img.copy()
    for box in boxes:
        class_pred = int(box[0])
        b = box[2:]
        ulx = int((b[0] - b[2] / 2) * w)
        uly = int((b[1] - b[3] / 2) * h)
        lrx = int((b[0] + b[2] / 2) * w)
        lry = int((b[1] + b[3] / 2) * h)
        ulx = min(max(ulx, 0), w - 1)
        uly = min(max(uly, 0), h - 1)
        lrx = min(max(lrx, 0), w - 1)
        lry = min(max(lry, 0), h - 1)
        cv2.rectangle(
            output_image, (ulx, uly), (lrx, lry), colors[class_pred], thickness=1
        )
        cv2.putText(
            output_image,
            class_names[class_pred],
            (ulx, uly - 5),
            cv2.FONT_HERSHEY_SIMPLEX,
            0.25,
            colors[class_pred],
            thickness=1,
        )
    if was_float:
        return output_image.astype(np.float32) / 255.0
    return output_image
