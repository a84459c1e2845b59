"""The multi-scale ELAN detection backbone (the "custom" encoder).

Counterpart of ``ConvBnAct``, ``ELANBlock`` and ``YOLOBackbone`` in
pixelnerf_yolo_tpu/models/yolo_backbone.py: P3/P4/P5 feature maps of
256/512/1024 channels at strides 8/16/32, whose channels sum to the
1792-d latent.  Layout is NCHW.

The submodules carry the flax module names (``ConvBnAct_i``,
``ELANBlock_j``, ``Conv_0``, ``BatchNorm_0``), so a flax parameter path
maps onto a state_dict key by joining it with dots (``convert.py``).

Precision as in nn/resnet.py: parameters are f32, convolutions run in the
compute dtype, BatchNorm (eps 1e-3, momentum 0.97; batch statistics with
``train=True``) normalizes in f32 and casts back; SiLU is
``x * sigmoid(x)`` in the compute dtype, as flax computes it.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..nn.resnet import batch_norm, conv

YOLO_BACKBONE_DIMS = [256, 512, 1024]  # strides 8, 16, 32
YOLO_BACKBONE_LATENT = sum(YOLO_BACKBONE_DIMS)  # 1792
BN_EPS = 1e-3
BN_MOMENTUM = 0.97


class ConvBnAct(nn.Module):
    """Conv (no bias, padding k // 2) -> BatchNorm -> SiLU."""

    def __init__(self, c_in: int, c_out: int, kernel: int = 3,
                 stride: int = 1, generator: torch.Generator | None = None):
        super().__init__()
        self.Conv_0 = nn.Conv2d(c_in, c_out, kernel, stride, kernel // 2,
                                bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(c_out, eps=BN_EPS)
        # flax's lecun-normal scale (std sqrt(1 / fan_in)), untruncated
        with torch.no_grad():
            self.Conv_0.weight.normal_(
                0.0, math.sqrt(1.0 / (c_in * kernel * kernel)),
                generator=generator)

    def forward(self, x: torch.Tensor, cdt: torch.dtype,
                train: bool = False) -> torch.Tensor:
        x = batch_norm(conv(x, self.Conv_0, cdt), self.BatchNorm_0, cdt,
                       train, BN_MOMENTUM)
        return x * torch.sigmoid(x)


class ELANBlock(nn.Module):
    """Two parallel 1x1 stems; the second runs a chain of 3x3 convs with a
    tap after every two; the taps [a, b, y1, y2] are concatenated and fused
    by a 1x1 conv."""

    def __init__(self, c_in: int, filters: int, depth: int = 2,
                 generator: torch.Generator | None = None):
        super().__init__()
        half = filters // 2
        self.depth = depth
        specs = [(c_in, half, 1), (c_in, half, 1)]
        specs += [(half, half, 3)] * (2 * depth)
        specs += [(half * (2 + depth), filters, 1)]
        for i, (ci, co, k) in enumerate(specs):
            self.add_module(f"ConvBnAct_{i}",
                            ConvBnAct(ci, co, k, generator=generator))

    def forward(self, x: torch.Tensor, cdt: torch.dtype,
                train: bool = False) -> torch.Tensor:
        a = self.ConvBnAct_0(x, cdt, train)
        y = self.ConvBnAct_1(x, cdt, train)
        taps = [a, y]
        for i in range(self.depth):
            y = getattr(self, f"ConvBnAct_{2 + 2 * i}")(y, cdt, train)
            y = getattr(self, f"ConvBnAct_{3 + 2 * i}")(y, cdt, train)
            taps.append(y)
        last = getattr(self, f"ConvBnAct_{2 + 2 * self.depth}")
        return last(torch.cat(taps, dim=1), cdt, train)


class YOLOBackbone(nn.Module):
    """[P3, P4, P5] NCHW maps (256/512/1024 channels at /8, /16, /32)."""

    # (kind, in, out, stride): the stem, then a stride-2 conv and an ELAN
    # per scale, in flax's call order
    PLAN = [("c", 3, 32, 1), ("c", 32, 64, 2), ("c", 64, 64, 1),
            ("c", 64, 128, 2), ("e", 128, 128, 1),
            ("c", 128, 256, 2), ("e", 256, 256, 1),
            ("c", 256, 512, 2), ("e", 512, 512, 1),
            ("c", 512, 1024, 2), ("e", 1024, 1024, 1)]
    TAPS = ("ELANBlock_1", "ELANBlock_2", "ELANBlock_3")

    def __init__(self, generator: torch.Generator | None = None):
        super().__init__()
        self.order = []
        n = {"c": 0, "e": 0}
        for kind, ci, co, stride in self.PLAN:
            if kind == "c":
                name = f"ConvBnAct_{n['c']}"
                mod = ConvBnAct(ci, co, 3, stride, generator=generator)
            else:
                name = f"ELANBlock_{n['e']}"
                mod = ELANBlock(ci, co, generator=generator)
            n[kind] += 1
            self.add_module(name, mod)
            self.order.append(name)

    def forward(self, x: torch.Tensor, cdt: torch.dtype,
                train: bool = False) -> list[torch.Tensor]:
        feats = []
        for name in self.order:
            x = getattr(self, name)(x, cdt, train)
            if name in self.TAPS:
                feats.append(x)
        return feats
