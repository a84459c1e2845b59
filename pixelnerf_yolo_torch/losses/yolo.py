"""Box IoU of the YOLO loss.

Counterpart of ``iou_xywh`` in pixelnerf_yolo_tpu/losses/yolo.py; the loss
itself (``YoloLoss``) comes with training (ROADMAP.md Queue 1 item 14).
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
