"""Loss layer: the RGB and alpha losses of NeRF training and the YOLO
detection loss."""

from .rgb import (
    AlphaLossNV2,
    RGBWithBackground,
    RGBWithUncertainty,
    get_alpha_loss,
    get_rgb_loss,
    l1_loss,
    mse_loss,
    weighted_rgb_loss,
)
from .yolo import YoloLoss, iou_xywh

__all__ = [
    "AlphaLossNV2",
    "RGBWithBackground",
    "RGBWithUncertainty",
    "YoloLoss",
    "get_alpha_loss",
    "get_rgb_loss",
    "iou_xywh",
    "l1_loss",
    "mse_loss",
    "weighted_rgb_loss",
]
