"""Training layer: the base loop, checkpoints and the NeRF and YOLO
trainers."""

from .nerf_trainer import PixelNeRFTrainer
from .trainer import Trainer
from .yolo_trainer import YOLOTrainer, make_trainer

__all__ = ["PixelNeRFTrainer", "Trainer", "YOLOTrainer", "make_trainer"]
