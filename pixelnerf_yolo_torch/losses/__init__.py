"""Loss layer: for now only the box IoU that detection uses."""

from .yolo import iou_xywh

__all__ = ["iou_xywh"]
