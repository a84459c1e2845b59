"""LPIPS (VGG16) perceptual distance.

Counterpart of pixelnerf_yolo_tpu/nn/lpips.py: a VGG16 trunk with five taps
(relu1_2, relu2_2, relu3_3, relu4_3, relu5_3), channel-unit-normalized
feature differences, non-negative 1x1 heads, the spatial mean, summed over
the taps (Zhang et al. 2018).  The convolutions are plain
``torch.nn.functional.conv2d``.

The weights are the JAX package's ``lpips_vgg.npz`` (torchvision VGG16
``features.*`` conv tensors and the LPIPS ``lin*.model.1.weight`` heads,
written by ``scripts/port_lpips.py``), looked up on nn/pretrained.py's
search path.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

# torchvision vgg16 ``features`` indices of the 13 convs, grouped by the
# five LPIPS slices (a 2x2 max pool between groups)
VGG16_SLICES = [
    [0, 2],
    [5, 7],
    [10, 12, 14],
    [17, 19, 21],
    [24, 26, 28],
]
# the published LPIPS input scaling
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def vgg16_taps(params: dict, x: torch.Tensor) -> list[torch.Tensor]:
    """:param x (N, 3, H, W) LPIPS-scaled input -> the 5 tap activations."""
    taps = []
    h = x
    for s, convs in enumerate(VGG16_SLICES):
        if s > 0:
            h = F.max_pool2d(h, 2, 2)
        for idx in convs:
            p = params[f"conv{idx}"]
            h = torch.relu(F.conv2d(h, p["kernel"], p["bias"], padding=1))
        taps.append(h)
    return taps


def _unit_normalize(h, eps=1e-10):
    return h / (torch.sqrt(torch.sum(h * h, dim=1, keepdim=True)) + eps)


def lpips_distance(params: dict, a: torch.Tensor, b: torch.Tensor):
    """LPIPS(a, b) for images in [-1, 1].

    :param a, b (N, 3, H, W)
    :return (N,) distances
    """
    shift = torch.tensor(_SHIFT, dtype=a.dtype, device=a.device)
    scale = torch.tensor(_SCALE, dtype=a.dtype, device=a.device)
    shift, scale = shift[None, :, None, None], scale[None, :, None, None]
    fa = vgg16_taps(params, (a - shift) / scale)
    fb = vgg16_taps(params, (b - shift) / scale)
    total = 0.0
    for i, (ha, hb) in enumerate(zip(fa, fb)):
        diff = (_unit_normalize(ha) - _unit_normalize(hb)) ** 2
        w = params[f"lin{i}"]["kernel"].reshape(1, -1, 1, 1)
        val = torch.sum(diff * w, dim=1, keepdim=True)
        total = total + torch.mean(val, dim=(1, 2, 3))
    return total


def port_lpips_state_dict(vgg_sd: dict, lin_sd: dict,
                          device="cpu") -> dict:
    """torchvision vgg16 ``features.*`` and lpips ``lin*.model.1.weight``
    tensors (numpy or torch) -> the params dict used above, f32 on
    ``device``."""

    def arr(v):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        return torch.from_numpy(np.asarray(v, dtype=np.float32)).to(device)

    params: dict = {}
    for convs in VGG16_SLICES:
        for idx in convs:
            params[f"conv{idx}"] = {
                "kernel": arr(vgg_sd[f"features.{idx}.weight"]),
                "bias": arr(vgg_sd[f"features.{idx}.bias"]),
            }
    for i in range(5):
        params[f"lin{i}"] = {"kernel": arr(lin_sd[f"lin{i}.model.1.weight"])}
    return params


def lpips_npz_path() -> str | None:
    from .pretrained import search_dirs

    for d in search_dirs():
        p = os.path.join(d, "lpips_vgg.npz")
        if os.path.exists(p):
            return p
    return None


def load_lpips(device="cpu") -> tuple[dict, str]:
    """(params, path) from ``lpips_vgg.npz`` on the pretrained search path,
    or raise FileNotFoundError with the porting instructions."""
    path = lpips_npz_path()
    if path is None:
        from .pretrained import search_dirs

        raise FileNotFoundError(
            "No lpips_vgg.npz found. Port the weights once with "
            "`python scripts/port_lpips.py` (needs `pip install lpips` "
            "there only) and place lpips_vgg.npz in one of: "
            + ", ".join(search_dirs())
        )
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    vgg_sd = {k: v for k, v in flat.items() if k.startswith("features.")}
    lin_sd = {k: v for k, v in flat.items() if k.startswith("lin")}
    return port_lpips_state_dict(vgg_sd, lin_sd, device), path
