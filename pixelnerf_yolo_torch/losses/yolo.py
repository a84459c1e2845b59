"""YOLO detection loss (4 components) with masked means.

Counterpart of pixelnerf_yolo_tpu/losses/yolo.py:
  * no-object: BCE of the predicted prob against 0 on cells whose target
    prob is 0 (the log clamped at -100, as torch's BCELoss does);
  * object: squared error of the predicted prob against IoU(decoded
    predicted box, target box) on cells whose target prob is 1, the IoU
    detached;
  * box: squared error of [sigmoid(xy), raw wh] against
    [target xy, log(1e-6 + target wh / anchor)];
  * class: cross-entropy over the 2 classes (log_softmax).
Each term is a mean over its mask, 0 when the mask is empty; cells with
target prob -1 (ignored) are in no mask.  A rank holding part of a sharded
chunk passes the chunk's counts, so that its terms are its part of each
mean.
"""

from __future__ import annotations

import torch


def iou_xywh(box1: torch.Tensor, box2: torch.Tensor) -> torch.Tensor:
    """Elementwise IoU of center-format [x, y, w, h] boxes (last dim 4,
    broadcasting)."""
    b1_x1 = box1[..., 0] - box1[..., 2] / 2
    b1_y1 = box1[..., 1] - box1[..., 3] / 2
    b1_x2 = box1[..., 0] + box1[..., 2] / 2
    b1_y2 = box1[..., 1] + box1[..., 3] / 2
    b2_x1 = box2[..., 0] - box2[..., 2] / 2
    b2_y1 = box2[..., 1] - box2[..., 3] / 2
    b2_x2 = box2[..., 0] + box2[..., 2] / 2
    b2_y2 = box2[..., 1] + box2[..., 3] / 2

    x1 = torch.maximum(b1_x1, b2_x1)
    y1 = torch.maximum(b1_y1, b2_y1)
    x2 = torch.minimum(b1_x2, b2_x2)
    y2 = torch.minimum(b1_y2, b2_y2)
    inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    area1 = torch.abs((b1_x2 - b1_x1) * (b1_y2 - b1_y1))
    area2 = torch.abs((b2_x2 - b2_x1) * (b2_y2 - b2_y1))
    return inter / (area1 + area2 - inter + 1e-6)


def _masked_mean(values: torch.Tensor, mask: torch.Tensor,
                 count=None) -> torch.Tensor:
    """Mean of values where mask; 0 when the mask is empty.  count: the
    mask's count over every rank's part (a sharded chunk), else its own."""
    if count is None:
        count = mask.sum()
    total = torch.where(mask, values, torch.zeros_like(values)).sum()
    return torch.where(count > 0, total / torch.clamp(count, min=1),
                       torch.zeros_like(total))


def _bce(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """torch.nn.BCELoss elementwise, the logs clamped at -100."""
    log_p = torch.clamp(torch.log(p), min=-100.0)
    log_1p = torch.clamp(torch.log(1.0 - p), min=-100.0)
    return -(t * log_p + (1.0 - t) * log_1p)


class YoloLoss:
    def __init__(self, num_anchors_per_scale, box_loss, object_loss,
                 no_object_loss, class_loss):
        self.num_anchors_per_scale = num_anchors_per_scale
        self.box_loss = box_loss
        self.object_loss = object_loss
        self.no_object_loss = no_object_loss
        self.class_loss = class_loss

    def __call__(self, pred: torch.Tensor, target: torch.Tensor,
                 anchors: torch.Tensor, counts=None):
        """:param pred (..., A, 7) renderer output [prob, x, y, w, h, c0, c1]
        :param target (..., A, 6) grid targets [prob, x, y, w, h, cls]
        :param anchors (A, 2)
        :param counts optional (object cells, no-object cells) of the whole
          chunk when pred and target are a rank's part of it: each mean
          divides this part's masked sum by the chunk's count
        :return (total, box, object, no_object, class) scalars
        """
        obj = target[..., 0] == 1
        no_obj = target[..., 0] == 0
        n_obj, n_no_obj = counts if counts is not None else (None, None)

        no_object_loss = _masked_mean(
            _bce(pred[..., 0], target[..., 0] * 0.0), no_obj, n_no_obj)

        anchors_b = anchors.reshape(
            (1,) * (pred.ndim - 2) + (self.num_anchors_per_scale, 2))
        box_preds = torch.cat([torch.sigmoid(pred[..., 1:3]),
                               torch.exp(pred[..., 3:5]) * anchors_b], dim=-1)
        ious = iou_xywh(box_preds, target[..., 1:5]).detach()
        object_loss = _masked_mean(
            (pred[..., 0] - ious * target[..., 0]) ** 2, obj, n_obj)

        pred_box = torch.cat([torch.sigmoid(pred[..., 1:3]), pred[..., 3:5]],
                             dim=-1)
        target_box = torch.cat(
            [target[..., 1:3], torch.log(1e-6 + target[..., 3:5] / anchors_b)],
            dim=-1)
        box_loss = _masked_mean(((pred_box - target_box) ** 2).mean(dim=-1),
                                obj, n_obj)

        log_probs = torch.log_softmax(pred[..., 5:], dim=-1)
        cls_idx = target[..., 5].to(torch.int64)
        ce = -torch.gather(log_probs, -1, cls_idx[..., None])[..., 0]
        class_loss = _masked_mean(ce, obj, n_obj)

        total = (box_loss * self.box_loss
                 + object_loss * self.object_loss
                 + no_object_loss * self.no_object_loss
                 + class_loss * self.class_loss)
        return total, box_loss, object_loss, no_object_loss, class_loss

    @classmethod
    def from_conf(cls, conf, num_anchors_per_scale) -> "YoloLoss":
        print("using weights for yolo loss")
        for k in ("box_loss", "object_loss", "no_object_loss", "class_loss"):
            print(k, conf["yolo.weights." + k])
        return cls(
            num_anchors_per_scale,
            conf["yolo.weights.box_loss"],
            conf["yolo.weights.object_loss"],
            conf["yolo.weights.no_object_loss"],
            conf["yolo.weights.class_loss"],
        )
