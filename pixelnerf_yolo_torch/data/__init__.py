"""Data layer: dataset factory and loader (numpy, host side).

Counterpart of pixelnerf_yolo_tpu/data/__init__.py: the format strings,
each format's z bounds and flags, and color jitter on the train splits of
``dvr_dtu`` and ``yolo``.
"""

from __future__ import annotations

from .color_jitter import ColorJitterDataset
from .dvr import DVRDataset
from .loader import DataLoader
from .multi_object import MultiObjectDataset
from .srn import SRNDataset
from .yolo import YOLODataset

__all__ = [
    "ColorJitterDataset",
    "DVRDataset",
    "DataLoader",
    "MultiObjectDataset",
    "SRNDataset",
    "YOLODataset",
    "get_split_dataset",
]


def get_split_dataset(dataset_type, datadir, want_split="all", training=True,
                      **kwargs):
    """The (train, val, test) datasets of a format (multi_obj, dvr,
    dvr_gen, dvr_dtu, srn, yolo), or the one ``want_split`` names."""
    dset_class, train_aug = None, None
    flags, train_aug_flags = {}, {}

    if dataset_type == "srn":
        dset_class = SRNDataset
    elif dataset_type == "multi_obj":
        dset_class = MultiObjectDataset
    elif dataset_type.startswith("dvr"):
        dset_class = DVRDataset
        if dataset_type == "dvr_gen":
            flags["list_prefix"] = "gen_"
        elif dataset_type == "dvr_dtu":
            flags["list_prefix"] = "new_"
            if training:
                flags["max_imgs"] = 49
            flags["sub_format"] = "dtu"
            flags["scale_focal"] = False
            flags["z_near"] = 0.1
            flags["z_far"] = 5.0
            train_aug = ColorJitterDataset
            train_aug_flags = {"extra_inherit_attrs": ["sub_format"]}
    elif dataset_type == "yolo":
        dset_class = YOLODataset
        flags["z_near"] = 1
        flags["z_far"] = 13.0
        train_aug = ColorJitterDataset
    else:
        raise NotImplementedError("Unsupported dataset type", dataset_type)

    want_train = want_split not in ("val", "test")
    want_val = want_split not in ("train", "test")
    want_test = want_split not in ("train", "val")

    train_set = val_set = test_set = None
    if want_train:
        train_set = dset_class(datadir, stage="train", **flags, **kwargs)
        if train_aug is not None:
            train_set = train_aug(train_set, **train_aug_flags)
    if want_val:
        val_set = dset_class(datadir, stage="val", **flags, **kwargs)
    if want_test:
        test_set = dset_class(datadir, stage="test", **flags, **kwargs)

    if want_split == "train":
        return train_set
    if want_split == "val":
        return val_set
    if want_split == "test":
        return test_set
    return train_set, val_set, test_set
