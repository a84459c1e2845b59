"""Training layer: the base loop, checkpoints and the YOLO trainer."""

from .trainer import Trainer
from .yolo_trainer import YOLOTrainer, make_trainer

__all__ = ["Trainer", "YOLOTrainer", "make_trainer"]
