"""Pretrained ImageNet backbone initialization.

Counterpart of pixelnerf_yolo_tpu/nn/pretrained.py.  With
``encoder.pretrained = True`` a ResNet encoder starts from torchvision's
ImageNet weights, read from ``<backbone>_imagenet.npz``: the torchvision
state_dict as numpy arrays under torchvision names (the file
``scripts/port_torchvision.py`` writes).  The first such file found in
``$PNY_PRETRAINED_DIR``, ``<repo>/weights/`` or
``~/.cache/pixelnerf_yolo_torch/`` is used.  The port's ResNet keeps
torchvision's module names, so the graft copies each tensor by name; the
npz's tensors that a truncated trunk lacks (and ``fc``) are ignored.
"""

from __future__ import annotations

import os

import numpy as np
import torch

_FILENAME = "{backbone}_imagenet.npz"


def search_dirs() -> list[str]:
    dirs = []
    env = os.environ.get("PNY_PRETRAINED_DIR")
    if env:
        dirs.append(env)
    repo_root = os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", ".."))
    dirs.append(os.path.join(repo_root, "weights"))
    dirs.append(os.path.join(os.path.expanduser("~"), ".cache",
                             "pixelnerf_yolo_torch"))
    return dirs


def pretrained_path(backbone: str) -> str | None:
    """First existing ``<backbone>_imagenet.npz`` on the search path."""
    name = _FILENAME.format(backbone=backbone)
    for d in search_dirs():
        p = os.path.join(d, name)
        if os.path.exists(p):
            return p
    return None


def save_backbone_npz(state_dict: dict, path: str) -> None:
    """Write a torchvision-style state_dict (tensors or arrays) as npz,
    without its integer counters (num_batches_tracked)."""
    arrays = {}
    for k, v in state_dict.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        v = np.asarray(v)
        if v.dtype == np.int64:
            continue
        arrays[k] = v
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)


def load_pretrained_backbone(backbone: str) -> tuple[dict, str]:
    """(torchvision-named numpy state_dict, path) for ``backbone``, or
    raise FileNotFoundError saying where the npz is looked for."""
    path = pretrained_path(backbone)
    if path is None:
        raise FileNotFoundError(
            f"No pretrained weights for '{backbone}'. Port torchvision's "
            "ImageNet weights once with `python scripts/port_torchvision.py "
            f"--backbone {backbone}` (torchvision needed there only) and "
            f"place {_FILENAME.format(backbone=backbone)} in one of: "
            + ", ".join(search_dirs())
            + ". Or set encoder.pretrained=False to train from random init "
            "without the warning.")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}, path


def graft(module: torch.nn.Module, state_dict: dict) -> int:
    """Copy the state_dict's arrays onto the module's parameters and
    buffers of the same name; names the module lacks are ignored, a shape
    mismatch raises.  Returns the number of tensors copied."""
    n = 0
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if name not in state_dict or t.dtype == torch.long:
                continue
            src = np.asarray(state_dict[name])
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"pretrained shape mismatch at {name}: "
                                 f"{src.shape} vs {tuple(t.shape)}")
            t.copy_(torch.from_numpy(src.astype(np.float32)))
            n += 1
    return n
