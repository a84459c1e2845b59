"""Data layer: dataset factory and loader (numpy, host side).

Counterpart of pixelnerf_yolo_tpu/data/__init__.py for the ``yolo`` format
(z bounds 1 and 13, color jitter on the train split); the SRN, DVR/DTU
and multi-object formats are not ported yet (ROADMAP.md Queue 1 item 15).
"""

from __future__ import annotations

from .color_jitter import ColorJitterDataset
from .loader import DataLoader
from .yolo import YOLODataset

__all__ = [
    "ColorJitterDataset",
    "DataLoader",
    "YOLODataset",
    "get_split_dataset",
]


def get_split_dataset(dataset_type, datadir, want_split="all", training=True,
                      **kwargs):
    if dataset_type != "yolo":
        raise NotImplementedError(
            f"dataset format {dataset_type!r} is not ported yet (ROADMAP.md "
            "Queue 1 item 15)")
    flags = {"z_near": 1, "z_far": 13.0}

    want_train = want_split not in ("val", "test")
    want_val = want_split not in ("train", "test")
    want_test = want_split not in ("train", "val")

    train_set = val_set = test_set = None
    if want_train:
        train_set = ColorJitterDataset(
            YOLODataset(datadir, stage="train", **flags, **kwargs))
    if want_val:
        val_set = YOLODataset(datadir, stage="val", **flags, **kwargs)
    if want_test:
        test_set = YOLODataset(datadir, stage="test", **flags, **kwargs)

    if want_split == "train":
        return train_set
    if want_split == "val":
        return val_set
    if want_split == "test":
        return test_set
    return train_set, val_set, test_set
