"""SAME-padding helpers for convolutions and the conv-block factory.

Counterpart of pixelnerf_yolo_tpu/utils/conv_pad.py (the reference's
``calc_same_pad_conv2d``, ``same_pad_conv2d``, ``get_norm_layer``,
``make_conv_2d`` and ``same_unpad_deconv2d``), on NCHW tensors.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.resnet import make_norm


def calc_same_pad_conv2d(t_shape, kernel_size: int = 3, stride: int = 1):
    """(pad_left, pad_right, pad_top, pad_bottom) for SAME conv output."""
    in_height, in_width = t_shape[-2:]
    out_height = math.ceil(in_height / stride)
    out_width = math.ceil(in_width / stride)
    pad_along_height = max((out_height - 1) * stride + kernel_size
                           - in_height, 0)
    pad_along_width = max((out_width - 1) * stride + kernel_size
                          - in_width, 0)
    pad_top = pad_along_height // 2
    pad_bottom = pad_along_height - pad_top
    pad_left = pad_along_width // 2
    pad_right = pad_along_width - pad_left
    return pad_left, pad_right, pad_top, pad_bottom


def same_pad_conv2d(t: torch.Tensor, padding_type: str = "reflect",
                    kernel_size: int = 3, stride: int = 1) -> torch.Tensor:
    """Pad (..., H, W) for SAME conv.  padding_type: constant | reflect |
    replicate | circular (``F.pad``'s modes)."""
    if padding_type not in ("constant", "reflect", "replicate", "circular"):
        raise KeyError(padding_type)
    pad = calc_same_pad_conv2d(t.shape, kernel_size, stride)
    if padding_type == "constant":
        return F.pad(t, pad)
    # F.pad's non-constant modes take a batched (N, C, H, W) tensor
    lead = t.shape[:-2]
    x = t.reshape((-1, 1) + tuple(t.shape[-2:]))
    x = F.pad(x, pad, mode=padding_type)
    return x.reshape(tuple(lead) + tuple(x.shape[-2:]))


def get_norm_layer(norm_type: str = "instance", group_norm_groups: int = 32):
    """Normalization-layer factory: a constructor of the norm module over a
    channel count (``nn.resnet.make_norm``: flax's epsilons, instance =
    one group per channel without scale or bias), or None for "none"."""
    if norm_type not in ("batch", "instance", "group", "none"):
        raise NotImplementedError(
            "normalization layer [%s] is not found" % norm_type)
    if norm_type == "none":
        return None
    return functools.partial(make_norm, norm_type, groups=group_norm_groups)


def make_conv_2d(dim_in: int, dim_out: int, padding_type: str = "reflect",
                 norm_layer=None, activation=None, kernel_size: int = 3,
                 use_leaky_relu: bool = False, use_bias: bool = False,
                 stride: int = 1) -> nn.Sequential:
    """[Conv2d (no padding), norm?, activation?]: its input must already be
    SAME-padded with ``same_pad_conv2d``.  ``norm_layer`` is a
    ``get_norm_layer`` constructor; ``activation`` a module or a function;
    else ``use_leaky_relu`` adds a leaky ReLU of slope 0.2."""
    layers = [nn.Conv2d(dim_in, dim_out, kernel_size, stride, 0,
                        bias=use_bias)]
    if norm_layer is not None:
        layers.append(norm_layer(dim_out))
    if activation is not None:
        layers.append(activation if isinstance(activation, nn.Module)
                      else _Fn(activation))
    elif use_leaky_relu:
        layers.append(nn.LeakyReLU(0.2))
    return nn.Sequential(*layers)


class _Fn(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def same_unpad_deconv2d(t: torch.Tensor, kernel_size: int = 3,
                        stride: int = 1) -> torch.Tensor:
    """Crop deconv output back to the SAME-padded shape."""
    h_scaled = (t.shape[-2] - 1) * stride
    w_scaled = (t.shape[-1] - 1) * stride
    left, right, top, bottom = calc_same_pad_conv2d(
        (h_scaled, w_scaled), kernel_size, stride)
    return t[..., top:t.shape[-2] - bottom if bottom > 0 else t.shape[-2],
             left:t.shape[-1] - right if right > 0 else t.shape[-1]]
