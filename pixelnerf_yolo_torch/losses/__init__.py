"""Loss layer: the YOLO detection loss and its box IoU."""

from .yolo import YoloLoss, iou_xywh

__all__ = ["YoloLoss", "iou_xywh"]
