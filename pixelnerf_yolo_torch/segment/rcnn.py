"""RPN + ROI box head of the PointRend R50-FPN detector (inference).

Counterpart of pixelnerf_yolo_tpu/segment/rcnn.py (detectron2's
GeneralizedRCNN as the reference's configs set it up): anchor sizes
32..512, one per level, x ratios (0.5, 1, 2); RPN pre/post-NMS top-k
1000/1000 (test), NMS 0.7; ROI pooling at 7x7 over p2-p5 by the FPN
level-assignment rule; the box head 2 x FC-1024; 80 COCO classes +
background; delta weights (10, 10, 5, 5).

ROIAlign keeps the JAX package's one documented deviation: a fixed 2x2
sampling grid per output bin (detectron2's ``sampling_ratio=0`` takes
ceil(roi / 7), which is 2 at each level's canonical box size).  It is
written with ``ops.grid_sample`` (no torchvision).

The ragged parts (anchors, box deltas, clipping, NMS, level grouping) run
on the host in numpy, copies of the JAX package's; the heads and the
sampling in torch on the features' device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.grid_sample import grid_sample_nhwc
from .backbone import conv

ANCHOR_SIZES = (32, 64, 128, 256, 512)  # one per p2..p6
ASPECT_RATIOS = (0.5, 1.0, 2.0)
RPN_LEVELS = ("p2", "p3", "p4", "p5", "p6")
SCALE_CLAMP = math.log(1000.0 / 16)
STRIDES_RPN = {"p2": 4, "p3": 8, "p4": 16, "p5": 32, "p6": 64}
FPN_CH = 256


# -- anchors (host) --------------------------------------------------------

def cell_anchors(size: float) -> np.ndarray:
    """(A, 4) xyxy anchors centred at 0 (detectron2
    generate_cell_anchors)."""
    out = []
    area = size * size
    for ar in ASPECT_RATIOS:
        w = math.sqrt(area / ar)
        h = ar * w
        out.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.array(out, np.float32)


def grid_anchors(feat_h: int, feat_w: int, stride: int,
                 size: float) -> np.ndarray:
    """(H*W*A, 4) anchors in (H, W, A) order, offset 0 (detectron2)."""
    base = cell_anchors(size)
    sx = np.arange(feat_w, dtype=np.float32) * stride
    sy = np.arange(feat_h, dtype=np.float32) * stride
    shift_x, shift_y = np.meshgrid(sx, sy)
    shifts = np.stack([shift_x.ravel(), shift_y.ravel()] * 2, axis=1)
    return (shifts[:, None, :] + base[None, :, :]).reshape(-1, 4)


# -- box transforms (host) -------------------------------------------------

def apply_deltas(deltas: np.ndarray, boxes: np.ndarray,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> np.ndarray:
    """Box2BoxTransform.apply_deltas: (..., 4) deltas onto (N, 4) xyxy."""
    widths = boxes[:, 2] - boxes[:, 0]
    heights = boxes[:, 3] - boxes[:, 1]
    ctr_x = boxes[:, 0] + 0.5 * widths
    ctr_y = boxes[:, 1] + 0.5 * heights
    wx, wy, ww, wh = weights
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = np.minimum(deltas[..., 2] / ww, SCALE_CLAMP)
    dh = np.minimum(deltas[..., 3] / wh, SCALE_CLAMP)
    shape = (-1,) + (1,) * (deltas.ndim - 2)
    pred_ctr_x = dx * widths.reshape(shape) + ctr_x.reshape(shape)
    pred_ctr_y = dy * heights.reshape(shape) + ctr_y.reshape(shape)
    pred_w = np.exp(dw) * widths.reshape(shape)
    pred_h = np.exp(dh) * heights.reshape(shape)
    return np.stack(
        [pred_ctr_x - 0.5 * pred_w, pred_ctr_y - 0.5 * pred_h,
         pred_ctr_x + 0.5 * pred_w, pred_ctr_y + 0.5 * pred_h], axis=-1)


def clip_boxes(boxes: np.ndarray, img_h: int, img_w: int) -> np.ndarray:
    out = boxes.copy()
    out[..., 0::2] = np.clip(out[..., 0::2], 0, img_w)
    out[..., 1::2] = np.clip(out[..., 1::2], 0, img_h)
    return out


def nms_xyxy(boxes: np.ndarray, scores: np.ndarray,
             iou_thresh: float) -> np.ndarray:
    """Greedy NMS, indices kept in descending-score order (torchvision
    semantics)."""
    order = np.argsort(-scores, kind="stable")
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        rest = order[1:]
        xx0 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy0 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx1 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy1 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.maximum(xx1 - xx0, 0) * np.maximum(yy1 - yy0, 0)
        iou = inter / np.maximum(areas[i] + areas[rest] - inter, 1e-12)
        order = rest[iou <= iou_thresh]
    return np.asarray(keep, np.int64)


def batched_nms(boxes: np.ndarray, scores: np.ndarray, ids: np.ndarray,
                iou_thresh: float) -> np.ndarray:
    """Category-aware NMS by the coordinate-offset trick."""
    if len(boxes) == 0:
        return np.zeros((0,), np.int64)
    offs = ids.astype(np.float32) * (boxes.max() + 1.0)
    return nms_xyxy(boxes + offs[:, None], scores, iou_thresh)


def assign_levels(boxes: np.ndarray, canonical_size: int = 224,
                  canonical_level: int = 4) -> np.ndarray:
    """FPN pooler level of each box (detectron2 assign_boxes_to_levels)."""
    areas = np.maximum(boxes[:, 2] - boxes[:, 0], 0) * np.maximum(
        boxes[:, 3] - boxes[:, 1], 0)
    lvl = np.floor(canonical_level
                   + np.log2(np.sqrt(areas) / canonical_size + 1e-8))
    return np.clip(lvl, 2, 5).astype(np.int64)


# -- RPN -------------------------------------------------------------------

def rpn_head_apply(params, feats: dict) -> dict:
    """The shared 3x3 conv + objectness / delta 1x1s per level (detectron2
    StandardRPNHead)."""
    out = {}
    for name in RPN_LEVELS:
        t = torch.relu(conv(feats[name], params["conv"]["weight"],
                            params["conv"]["bias"], padding=1))
        obj = conv(t, params["objectness_logits"]["weight"],
                   params["objectness_logits"]["bias"])
        deltas = conv(t, params["anchor_deltas"]["weight"],
                      params["anchor_deltas"]["bias"])
        out[name] = (obj, deltas)
    return out


def rpn_proposals(rpn_out: dict, img_h: int, img_w: int,
                  pre_nms_topk: int = 1000, post_nms_topk: int = 1000,
                  nms_thresh: float = 0.7) -> tuple[np.ndarray, np.ndarray]:
    """find_top_rpn_proposals (test mode), on the host: (boxes xyxy,
    scores)."""
    all_boxes, all_scores, all_lvl = [], [], []
    for li, name in enumerate(RPN_LEVELS):
        obj, deltas = rpn_out[name]
        A = len(ASPECT_RATIOS)
        _, _, fh, fw = obj.shape
        # (1, A, H, W) -> (H, W, A) order; deltas (1, A*4, H, W) ->
        # (H*W*A, 4): detectron2's permute convention
        obj = obj[0].cpu().numpy().transpose(1, 2, 0).reshape(-1)
        deltas = (deltas[0].cpu().numpy().reshape(A, 4, fh, fw)
                  .transpose(2, 3, 0, 1).reshape(-1, 4))
        anchors = grid_anchors(fh, fw, STRIDES_RPN[name], ANCHOR_SIZES[li])
        k = min(pre_nms_topk, len(obj))
        top = np.argpartition(-obj, k - 1)[:k]
        all_boxes.append(apply_deltas(deltas[top], anchors[top]))
        all_scores.append(obj[top])
        all_lvl.append(np.full(k, li, np.int64))
    boxes = clip_boxes(np.concatenate(all_boxes), img_h, img_w)
    scores = np.concatenate(all_scores)
    lvl = np.concatenate(all_lvl)
    wide = ((boxes[:, 2] - boxes[:, 0]) > 0) & ((boxes[:, 3] - boxes[:, 1])
                                                > 0)
    boxes, scores, lvl = boxes[wide], scores[wide], lvl[wide]
    keep = batched_nms(boxes, scores, lvl, nms_thresh)[:post_nms_topk]
    return boxes[keep], scores[keep]


# -- ROIAlign + pooler -----------------------------------------------------

def roi_align(feat: torch.Tensor, boxes: np.ndarray, out_size: int,
              spatial_scale: float) -> torch.Tensor:
    """ROIAlignV2 (aligned=True) with a fixed 2x2 sample grid per bin.

    :param feat (1, C, H, W); boxes (R, 4) xyxy image coords
    :return (R, C, out_size, out_size)
    """
    R = len(boxes)
    _, C, H, W = feat.shape
    if R == 0:
        return feat.new_zeros((0, C, out_size, out_size))
    b = torch.as_tensor(boxes, dtype=torch.float32, device=feat.device)
    b = b * spatial_scale - 0.5  # aligned=True shift
    x0, y0 = b[:, 0], b[:, 1]
    bw = torch.clamp(b[:, 2] - b[:, 0], min=1e-6)
    bh = torch.clamp(b[:, 3] - b[:, 1], min=1e-6)
    n = out_size * 2  # 2 samples per bin edge
    t = (torch.arange(n, dtype=feat.dtype, device=feat.device) + 0.5) / n
    px = x0[:, None] + t[None, :] * bw[:, None]  # (R, n)
    py = y0[:, None] + t[None, :] * bh[:, None]
    # to grid_sample's normalized coords (align_corners=False centres)
    gx = (px + 0.5) * (2.0 / W) - 1.0
    gy = (py + 0.5) * (2.0 / H) - 1.0
    grid = torch.stack([gx[:, None, :].expand(R, n, n),
                        gy[:, :, None].expand(R, n, n)],
                       dim=-1).reshape(1, R * n * n, 2)
    flat = feat.reshape(C, H * W).T[None]  # (1, H*W, C)
    sampled = grid_sample_nhwc(flat, grid, H, W, padding_mode="border",
                               align_corners=False).reshape(R, n, n, C)
    pooled = sampled.reshape(R, out_size, 2, out_size, 2, C).mean((2, 4))
    return pooled.permute(0, 3, 1, 2)


def pool_roi_features(feats: dict, boxes: np.ndarray,
                      out_size: int = 7) -> torch.Tensor:
    """(R, 256, out, out) pooled from each box's assigned pyramid level."""
    R = len(boxes)
    lvl = assign_levels(boxes)
    p2 = feats["p2"]
    out = p2.new_zeros((R, FPN_CH, out_size, out_size))
    for level in range(2, 6):
        idx = np.nonzero(lvl == level)[0]
        if len(idx) == 0:
            continue
        out[torch.as_tensor(idx, device=p2.device)] = roi_align(
            feats[f"p{level}"], boxes[idx], out_size,
            1.0 / STRIDES_RPN[f"p{level}"])
    return out


# -- box head + inference --------------------------------------------------

def box_head_apply(params, pooled: torch.Tensor):
    """2 x FC-1024 (FastRCNNConvFCHead) + the linear predictors:
    (scores (R, 81), deltas (R, 320))."""
    x = pooled.reshape(pooled.shape[0], -1)
    x = torch.relu(x @ params["fc1"]["weight"].T + params["fc1"]["bias"])
    x = torch.relu(x @ params["fc2"]["weight"].T + params["fc2"]["bias"])
    scores = x @ params["cls_score"]["weight"].T + params["cls_score"]["bias"]
    deltas = x @ params["bbox_pred"]["weight"].T + params["bbox_pred"]["bias"]
    return scores, deltas


def box_inference(scores: torch.Tensor, deltas: np.ndarray,
                  proposals: np.ndarray, img_h: int, img_w: int,
                  score_thresh: float = 0.5, nms_thresh: float = 0.5,
                  topk: int = 100):
    """fast_rcnn_inference for one image: -> (boxes, scores, classes).
    The softmax runs in torch on the scores' device, the rest on the
    host."""
    probs = torch.softmax(torch.as_tensor(scores), dim=-1).cpu().numpy()
    probs = probs[:, :-1]  # drop background (last column)
    n_cls = probs.shape[1]
    boxes = apply_deltas(deltas.reshape(-1, n_cls, 4), proposals,
                         weights=(10.0, 10.0, 5.0, 5.0))
    boxes = clip_boxes(boxes, img_h, img_w)
    ri, ci = np.nonzero(probs > score_thresh)
    sel_boxes = boxes[ri, ci]
    sel_scores = probs[ri, ci]
    keep = batched_nms(sel_boxes, sel_scores, ci, nms_thresh)[:topk]
    return sel_boxes[keep], sel_scores[keep], ci[keep]
