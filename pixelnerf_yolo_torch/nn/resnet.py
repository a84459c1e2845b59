"""ResNet-18/34 trunk with multi-scale feature taps, BatchNorm in eval mode.

Counterpart of ``BasicBlock`` and ``ResNetFeatures`` in
pixelnerf_yolo_tpu/nn/resnet.py, with torchvision's module names (conv1,
bn1, layerN.M.{conv1,bn1,conv2,bn2,downsample.0,downsample.1}) so that the
state_dict keys are the reference's ``encoder.model.*``.  Layout is NCHW.

Precision: parameters are f32.  Convolutions run in the compute dtype;
BatchNorm normalizes in f32 as ``(x - mean) * (scale * rsqrt(var + eps)) +
bias`` and casts back to the compute dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

STAGE_SIZES = {"resnet18": [2, 2, 2, 2], "resnet34": [3, 4, 6, 3]}
# channel sizes of [stem, layer1..layer4] outputs
STAGE_WIDTHS = [64, 64, 128, 256, 512]
BN_EPS = 1e-5


def conv(x: torch.Tensor, m: nn.Conv2d, cdt: torch.dtype) -> torch.Tensor:
    return F.conv2d(x.to(cdt), m.weight.to(cdt), None, m.stride, m.padding)


def batch_norm(x: torch.Tensor, m: nn.BatchNorm2d, cdt: torch.dtype):
    mul = torch.rsqrt(m.running_var + m.eps) * m.weight
    y = (x.float() - m.running_mean[:, None, None]) * mul[:, None, None]
    return (y + m.bias[:, None, None]).to(cdt)


class BasicBlock(nn.Module):
    """torchvision BasicBlock: conv-bn-relu-conv-bn + (projected) identity."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes, eps=BN_EPS)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes, eps=BN_EPS)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride, bias=False),
                nn.BatchNorm2d(planes, eps=BN_EPS),
            )

    def forward(self, x: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
        out = torch.relu(batch_norm(conv(x, self.conv1, cdt), self.bn1, cdt))
        out = batch_norm(conv(out, self.conv2, cdt), self.bn2, cdt)
        identity = x
        if self.downsample is not None:
            identity = batch_norm(
                conv(x, self.downsample[0], cdt), self.downsample[1], cdt
            )
        return torch.relu(out + identity)


class ResNetFeatures(nn.Module):
    """ResNet trunk returning [stem, layer1, layer2, layer3, layer4] maps
    (NCHW), truncated at ``num_layers`` entries; only the stages it returns
    are built."""

    def __init__(self, backbone: str = "resnet34", num_layers: int = 4,
                 use_first_pool: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        if backbone not in STAGE_SIZES:
            raise NotImplementedError(f"backbone {backbone!r} is not ported")
        self.num_layers = num_layers
        self.use_first_pool = use_first_pool
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=BN_EPS)
        inplanes = 64
        for stage_idx, (planes, n_blocks) in enumerate(
            zip([64, 128, 256, 512], STAGE_SIZES[backbone]), start=1
        ):
            if num_layers <= stage_idx:
                break
            stride = 1 if stage_idx == 1 else 2
            blocks = [BasicBlock(inplanes, planes, stride)]
            blocks += [BasicBlock(planes, planes) for _ in range(n_blocks - 1)]
            self.add_module(f"layer{stage_idx}", nn.Sequential(*blocks))
            inplanes = planes
        # torchvision's init (kaiming normal, fan_out) from the generator;
        # BatchNorm starts at weight 1, bias 0, mean 0, var 1
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
                    m.weight.normal_(0.0, (2.0 / fan_out) ** 0.5,
                                     generator=generator)

    def forward(self, x: torch.Tensor, cdt: torch.dtype) -> list[torch.Tensor]:
        x = torch.relu(batch_norm(conv(x, self.conv1, cdt), self.bn1, cdt))
        latents = [x]
        if self.num_layers > 1 and self.use_first_pool:
            x = F.max_pool2d(x, 3, 2, 1)
        for stage_idx in range(1, 5):
            if self.num_layers <= stage_idx:
                break
            for block in getattr(self, f"layer{stage_idx}"):
                x = block(x, cdt)
            latents.append(x)
        return latents
