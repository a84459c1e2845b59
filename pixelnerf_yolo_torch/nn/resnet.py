"""ResNet-18/34 trunk with multi-scale feature taps.

Counterpart of ``BasicBlock`` and ``ResNetFeatures`` in
pixelnerf_yolo_tpu/nn/resnet.py, with torchvision's module names (conv1,
bn1, layerN.M.{conv1,bn1,conv2,bn2,downsample.0,downsample.1}) so that the
state_dict keys are the reference's ``encoder.model.*``.  Layout is NCHW.

Precision: parameters are f32.  Convolutions run in the compute dtype;
BatchNorm normalizes in f32 as ``(x - mean) * (scale * rsqrt(var + eps)) +
bias`` and casts back to the compute dtype.

``norm_type`` (JAX ``make_norm``) picks the trunk's normalization: batch
(the default), group (``nn.GroupNorm`` of 32 groups with scale and bias,
flax's eps 1e-6), instance (one group per channel, no scale, no bias, eps
1e-6) or none.  The group norms hold no running statistics; they
normalize each sample in f32 with ``torch.var_mean``'s biased variance
(``group_norm``) and, as flax's GroupNorm promotes to its f32 parameters,
return f32 when they have a scale and bias, the compute dtype when not.

BatchNorm follows flax ``nn.BatchNorm``: with ``train=False`` it uses the
running statistics; with ``train=True`` the batch's, in f32, with the
biased variance (divided by N), and it updates the running statistics as
``momentum * old + (1 - momentum) * batch`` (momentum 0.9 here, 0.97 in
the ELAN backbone).  ``F.batch_norm`` is not used: it updates
``running_var`` with the unbiased variance.  The variance is
``torch.var_mean``'s, not flax's ``E[x^2] - E[x]^2``: the same value to
f32 rounding, but the latter's gradient cancels, and on the CPU's sums
over an NCHW map it moved the encoder's parameter gradients up to 5e-4
(relative L2) off an f64 reference where flax and ``var_mean`` stay
within 3e-6 (tests/test_torch_train_encoder.py).

Inside ``parallel.collectives.synced_batch_norm(group)`` a train-mode
BatchNorm takes the statistics of the whole batch over the group's ranks
(SyncBatchNorm): each rank's (count, mean, M2) from ``torch.var_mean``,
gathered and combined with Chan's parallel formula, the gradient flowing
through the gathered statistics to every rank; the running statistics
take the combined ones.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import batch_norm_group, gather_stats

STAGE_SIZES = {"resnet18": [2, 2, 2, 2], "resnet34": [3, 4, 6, 3]}
# channel sizes of [stem, layer1..layer4] outputs
STAGE_WIDTHS = [64, 64, 128, 256, 512]
BN_EPS = 1e-5
BN_MOMENTUM = 0.9
GN_EPS = 1e-6  # flax nn.GroupNorm's epsilon
NORM_TYPES = ("batch", "instance", "group", "none")


def make_norm(norm_type: str, channels: int, groups: int = 32) -> nn.Module:
    """The norm module of ``norm_type`` over ``channels`` (JAX
    ``make_norm``); ``norm`` applies it."""
    if norm_type == "batch":
        return nn.BatchNorm2d(channels, eps=BN_EPS)
    if norm_type == "instance":
        return nn.GroupNorm(channels, channels, eps=GN_EPS, affine=False)
    if norm_type == "group":
        return nn.GroupNorm(groups, channels, eps=GN_EPS)
    if norm_type == "none":
        return nn.Identity()
    raise NotImplementedError(f"norm layer [{norm_type}] is not found")


def conv(x: torch.Tensor, m: nn.Conv2d, cdt: torch.dtype) -> torch.Tensor:
    return F.conv2d(x.to(cdt), m.weight.to(cdt), None, m.stride, m.padding)


def batch_norm(x: torch.Tensor, m: nn.BatchNorm2d, cdt: torch.dtype,
               train: bool = False, momentum: float = BN_MOMENTUM):
    """BatchNorm of an NCHW map (flax semantics, see the module doc)."""
    x = x.float()
    if train:
        group = batch_norm_group()
        if group is None:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        else:
            var, mean = synced_var_mean(x, group)
        with torch.no_grad():
            m.running_mean.copy_(momentum * m.running_mean
                                 + (1 - momentum) * mean)
            m.running_var.copy_(momentum * m.running_var
                                + (1 - momentum) * var)
    else:
        mean, var = m.running_mean, m.running_var
    mul = torch.rsqrt(var + m.eps) * m.weight
    y = (x - mean[:, None, None]) * mul[:, None, None]
    return (y + m.bias[:, None, None]).to(cdt)


def synced_var_mean(x: torch.Tensor, group):
    """(biased variance, mean) per channel of an NCHW map over the batch of
    every rank of group: Chan's combination of each rank's (count, mean,
    M2), not E[x^2] - E[x]^2."""
    n = x.numel() // x.shape[1]
    var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
    count = torch.full_like(mean, float(n))
    stats = gather_stats(torch.stack([count, mean, var * n]), group)
    counts, means, m2s = stats.unbind(1)
    total = counts.sum(0)
    mean_all = (counts * means).sum(0) / total
    m2 = (m2s + counts * (means - mean_all) ** 2).sum(0)
    return m2 / total, mean_all


def group_norm(x: torch.Tensor, m: nn.GroupNorm,
               cdt: torch.dtype) -> torch.Tensor:
    """GroupNorm of an NCHW map in f32, flax's order of operations:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``."""
    B, C = x.shape[:2]
    xg = x.float().reshape(B, m.num_groups, -1)
    var, mean = torch.var_mean(xg, dim=-1, unbiased=False, keepdim=True)
    y = (xg - mean).reshape(x.shape)
    mul = torch.rsqrt(var + m.eps).expand(B, m.num_groups,
                                          C // m.num_groups).reshape(B, C)
    if not m.affine:
        return (y * mul[:, :, None, None]).to(cdt)
    y = y * (mul * m.weight)[:, :, None, None]
    return y + m.bias[:, None, None]


def norm(x: torch.Tensor, m: nn.Module, cdt: torch.dtype, train: bool = False,
         momentum: float = BN_MOMENTUM) -> torch.Tensor:
    """Apply a ``make_norm`` module: BatchNorm (``batch_norm``), a group
    norm (``group_norm``, the same in train and eval) or none."""
    if isinstance(m, nn.BatchNorm2d):
        return batch_norm(x, m, cdt, train, momentum)
    if isinstance(m, nn.GroupNorm):
        return group_norm(x, m, cdt)
    return x


class BasicBlock(nn.Module):
    """torchvision BasicBlock: conv-bn-relu-conv-bn + (projected) identity."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 norm_type: str = "batch"):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = make_norm(norm_type, planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = make_norm(norm_type, planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride, bias=False),
                make_norm(norm_type, planes),
            )

    def forward(self, x: torch.Tensor, cdt: torch.dtype,
                train: bool = False) -> torch.Tensor:
        out = torch.relu(norm(conv(x, self.conv1, cdt), self.bn1, cdt, train))
        out = norm(conv(out, self.conv2, cdt), self.bn2, cdt, train)
        identity = x
        if self.downsample is not None:
            identity = norm(conv(x, self.downsample[0], cdt),
                            self.downsample[1], cdt, train)
        return torch.relu(out + identity)


class ResNetFeatures(nn.Module):
    """ResNet trunk returning [stem, layer1, layer2, layer3, layer4] maps
    (NCHW), truncated at ``num_layers`` entries; only the stages it returns
    are built."""

    def __init__(self, backbone: str = "resnet34", num_layers: int = 4,
                 use_first_pool: bool = True, norm_type: str = "batch",
                 generator: torch.Generator | None = None):
        super().__init__()
        if backbone not in STAGE_SIZES:
            raise NotImplementedError(f"backbone {backbone!r} is not ported")
        self.num_layers = num_layers
        self.use_first_pool = use_first_pool
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = make_norm(norm_type, 64)
        inplanes = 64
        for stage_idx, (planes, n_blocks) in enumerate(
            zip([64, 128, 256, 512], STAGE_SIZES[backbone]), start=1
        ):
            if num_layers <= stage_idx:
                break
            stride = 1 if stage_idx == 1 else 2
            blocks = [BasicBlock(inplanes, planes, stride, norm_type)]
            blocks += [BasicBlock(planes, planes, norm_type=norm_type)
                       for _ in range(n_blocks - 1)]
            self.add_module(f"layer{stage_idx}", nn.Sequential(*blocks))
            inplanes = planes
        # torchvision's init (kaiming normal, fan_out) from the generator;
        # a norm starts at weight 1, bias 0 (BatchNorm: mean 0, var 1)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
                    m.weight.normal_(0.0, (2.0 / fan_out) ** 0.5,
                                     generator=generator)

    def forward(self, x: torch.Tensor, cdt: torch.dtype,
                train: bool = False) -> list[torch.Tensor]:
        x = torch.relu(norm(conv(x, self.conv1, cdt), self.bn1, cdt, train))
        latents = [x]
        if self.num_layers > 1 and self.use_first_pool:
            x = F.max_pool2d(x, 3, 2, 1)
        for stage_idx in range(1, 5):
            if self.num_layers <= stage_idx:
                break
            for block in getattr(self, f"layer{stage_idx}"):
                x = block(x, cdt, train)
            latents.append(x)
        return latents
