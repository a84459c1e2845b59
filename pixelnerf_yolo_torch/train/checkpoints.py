"""Checkpoint persistence in the JAX package's file layout.

Counterpart of pixelnerf_yolo_tpu/train/checkpoints.py:
  checkpoints/<name>/pixel_nerf_latest      model weights (latest)
  checkpoints/<name>/pixel_nerf_init        optional warm-start weights
  checkpoints/<name>/pixel_nerf_backup<N>   rolling pre-save copies
  checkpoints/<name>/pixel_nerf_backup_best best-F1 copy (epochNum="_best")
  checkpoints/<name>/_optim                 optimizer state
  checkpoints/<name>/_lrsched               lr schedule state
  checkpoints/<name>/_iter                  iteration counter
  checkpoints/<name>/_renderer              renderer schedule state

The weights are the model's ``state_dict`` and the optimizer state is
``torch.optim.Adam.state_dict()``, each written with ``torch.save``; the
small states (_iter, _lrsched, _renderer) are JSON.  Every write goes to a
temporary file first and replaces the old one, so a run killed mid-save
leaves the previous checkpoint whole.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import warnings
from shutil import copyfile

import torch


def save_state(path: str, obj) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def load_state(path: str, map_location="cpu"):
    return torch.load(path, map_location=map_location, weights_only=True)


def save_json(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def load_json(path: str):
    with open(path, "r") as f:
        return json.load(f)


def ckpt_dir(args) -> str:
    return osp.join(args.checkpoints_path, args.name)


def has_weights(args) -> bool:
    """Whether load_weights(args, ...) would find a checkpoint to load."""
    name = "pixel_nerf_latest" if args.resume else "pixel_nerf_init"
    return osp.exists(osp.join(ckpt_dir(args), name))


def load_weights(args, model, opt_init: bool = False) -> bool:
    """Load the model's weights in place: pixel_nerf_latest when resuming,
    else pixel_nerf_init when there is one.  Returns whether it loaded."""
    if opt_init and not args.resume:
        return False
    ckpt_name = (
        "pixel_nerf_init" if opt_init or not args.resume else "pixel_nerf_latest"
    )
    model_path = osp.join(ckpt_dir(args), ckpt_name)
    if os.path.exists(model_path):
        print("Load", model_path)
        model.load_state_dict(load_state(model_path))
        return True
    if not opt_init:
        warnings.warn(
            f"WARNING: {model_path} does not exist, not loaded!! "
            "Model will be re-initialized.\n"
            "If you are trying to load a pretrained model, STOP since it's "
            "not in the right place. If training, unless you are starting a "
            "new experiment, please remember to pass --resume."
        )
    return False


def save_weights(args, model, opt_init: bool = False, epochNum: str = "",
                 state=None):
    """Save the model's state_dict (or ``state``, the one to write),
    copying the previous file to the backup name first; with an epochNum
    only the backup copy is made."""
    ckpt_name = "pixel_nerf_init" if opt_init else "pixel_nerf_latest"
    backup_name = (
        "pixel_nerf_init_backup" if opt_init else "pixel_nerf_backup" + epochNum
    )
    d = ckpt_dir(args)
    os.makedirs(d, exist_ok=True)
    ckpt_path = osp.join(d, ckpt_name)
    if osp.exists(ckpt_path):
        copyfile(ckpt_path, osp.join(d, backup_name))
    if epochNum == "":
        save_state(ckpt_path, model.state_dict() if state is None else state)
