"""End-to-end PointRend predictor (detectron2 DefaultPredictor).

Counterpart of pixelnerf_yolo_tpu/segment/predictor.py.  Per photo:

  BGR uint8 -> resize the shortest edge to ``min_size`` (the longest capped
  at ``max_size``) -> subtract the caffe pixel means (no std) -> pad to a
  multiple of 64 -> backbone / RPN / ROI box head -> detections above
  ``score_thresh`` -> PointRend masks -> pasted at the original size.

Weights: ``pointrend_r50fpn.npz`` on ``nn.pretrained.search_dirs`` (what
``scripts/port_detectron2.py`` writes from the published checkpoint), or a
params tree (``port.random_params``).  Needs no cv2.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..nn.pretrained import search_dirs
from ..ops.resize import resize_bilinear
from .backbone import backbone_apply
from .pointrend import mask_point_inference, paste_masks
from .port import port_detectron2_state_dict, tree_to
from .rcnn import (
    box_head_apply,
    box_inference,
    pool_roi_features,
    rpn_head_apply,
    rpn_proposals,
)

# detectron2's caffe-style cfg.MODEL.PIXEL_MEAN (BGR)
PIXEL_MEAN_BGR = np.array([103.530, 116.280, 123.675], np.float32)
_FILENAME = "pointrend_r50fpn.npz"
PAD_DIVISOR = 64  # the backbone's deepest stride (p6)


def pointrend_npz_path() -> str | None:
    for d in search_dirs():
        p = os.path.join(d, _FILENAME)
        if os.path.exists(p):
            return p
    return None


def load_pointrend_params() -> dict:
    path = pointrend_npz_path()
    if path is None:
        raise FileNotFoundError(
            f"{_FILENAME} not found in {search_dirs()}; run "
            "scripts/port_detectron2.py on a machine with the detectron2 "
            "PointRend checkpoint to create it")
    with np.load(path) as z:
        sd = {k: z[k] for k in z.files}
    return port_detectron2_state_dict(sd)


def _empty(h0: int, w0: int) -> dict:
    return dict(boxes=np.zeros((0, 4), np.float32),
                scores=np.zeros((0,), np.float32),
                classes=np.zeros((0,), np.int64),
                masks=np.zeros((0, h0, w0), np.uint8))


class PointRendPredictor:
    """BGR image -> detections and masks (``detect``), or the reference
    wrapper's list of (H, W) uint8 {0, 255} masks, best instance first
    (``segment``).  Runs on ``device`` (the card unless the caller asks
    for the CPU)."""

    def __init__(self, params: dict | None = None, filter_class: int = -1,
                 score_thresh: float = 0.5, min_size: int = 800,
                 max_size: int = 1333, device="cuda"):
        self.device = torch.device(device)
        params = params if params is not None else load_pointrend_params()
        self.params = tree_to(params, self.device)
        self.filter_class = filter_class
        self.score_thresh = score_thresh
        self.min_size = min_size
        self.max_size = max_size

    def _preprocess(self, img_bgr: np.ndarray):
        h, w = img_bgr.shape[:2]
        scale = self.min_size / min(h, w)
        if max(h, w) * scale > self.max_size:
            scale = self.max_size / max(h, w)
        nh, nw = round(h * scale), round(w * scale)
        x = torch.as_tensor(np.asarray(img_bgr, np.float32),
                            device=self.device).permute(2, 0, 1)[None]
        x = resize_bilinear(x, (nh, nw), align_corners=False)
        x = x - torch.from_numpy(PIXEL_MEAN_BGR).to(self.device)[
            None, :, None, None]
        x = F.pad(x, (0, -nw % PAD_DIVISOR, 0, -nh % PAD_DIVISOR))
        return x, (nh, nw)

    @torch.no_grad()
    def detect(self, img_bgr: np.ndarray) -> dict:
        """-> dict(boxes (R, 4) xyxy in the ORIGINAL pixels, scores (R,),
        classes (R,), masks (R, H, W) uint8), as numpy arrays."""
        h0, w0 = img_bgr.shape[:2]
        x, (nh, nw) = self._preprocess(img_bgr)
        feats = backbone_apply(self.params["backbone"], x)
        rpn_out = rpn_head_apply(self.params["rpn_head"], feats)
        proposals, _ = rpn_proposals(rpn_out, nh, nw)
        if len(proposals) == 0:
            return _empty(h0, w0)
        pooled = pool_roi_features(feats, proposals)
        scores, deltas = box_head_apply(self.params["box_head"], pooled)
        boxes, det_scores, classes = box_inference(
            scores, deltas.cpu().numpy(), proposals, nh, nw,
            score_thresh=self.score_thresh)
        if self.filter_class >= 0:
            keep = classes == self.filter_class
            boxes, det_scores, classes = (boxes[keep], det_scores[keep],
                                          classes[keep])
        if len(boxes) == 0:
            return _empty(h0, w0)
        masks224 = mask_point_inference(self.params["roi_heads"],
                                        feats["p2"], boxes, classes)
        # detector_postprocess: boxes and masks at the input resolution
        sx, sy = w0 / nw, h0 / nh
        boxes_orig = boxes * np.array([sx, sy, sx, sy], np.float32)
        masks = paste_masks(masks224, boxes_orig, h0, w0)
        return dict(boxes=boxes_orig, scores=det_scores, classes=classes,
                    masks=masks)

    def segment(self, img_bgr: np.ndarray) -> list[np.ndarray]:
        """(H, W) uint8 {0, 255} masks, best instance first."""
        return [m * np.uint8(255) for m in self.detect(img_bgr)["masks"]]
