"""Fully-connected ResNet field MLP with per-block latent injection and
multi-view averaging at a combine layer.

Counterpart of ``ResnetBlockFC`` and ``ResnetFC`` in
pixelnerf_yolo_tpu/nn/resnetfc.py, with the reference's module names
(lin_in, lin_z.N, blocks.N.fc_0/fc_1/shortcut, lin_out).  This is the plain
path (``model.use_fused_mlp = false``); the fused kernels live in
ops/field_mlp.py.

Precision: parameters are f32.  Every hidden Dense follows flax's rounding
points in the compute dtype: the product is rounded to the compute dtype,
then the bias (cast to the compute dtype) is added.  lin_out runs in f32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.indexing import combine_interleaved


def dense(x: torch.Tensor, m: nn.Linear, cdt: torch.dtype) -> torch.Tensor:
    y = F.linear(x.to(cdt), m.weight.to(cdt))
    if m.bias is not None:
        y = y + m.bias.to(cdt)
    return y


def activation(beta: float):
    if beta > 0:
        return lambda x: torch.logaddexp(beta * x, torch.zeros_like(x)) / beta
    return torch.relu


def kaiming_fan_in_(w: torch.Tensor, generator: torch.Generator | None):
    """torch kaiming_normal_(a=0, mode="fan_in") with an explicit generator."""
    with torch.no_grad():
        w.normal_(0.0, math.sqrt(2.0 / w.shape[1]), generator=generator)


def _linear(d_in: int, d_out: int, generator, bias: bool = True,
            zero: bool = False) -> nn.Linear:
    m = nn.Linear(d_in, d_out, bias=bias)
    with torch.no_grad():
        if zero:
            m.weight.zero_()
        else:
            kaiming_fan_in_(m.weight, generator)
        if bias:
            m.bias.zero_()
    return m


class ResnetBlockFC(nn.Module):
    """act -> fc_0 -> act -> fc_1, plus (projected) shortcut; fc_1 is
    zero-initialized so a fresh block is the identity."""

    def __init__(self, size_in: int, size_out: int | None = None,
                 size_h: int | None = None, beta: float = 0.0,
                 dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        size_out = size_out or size_in
        size_h = size_h or min(size_in, size_out)
        self.beta = beta
        self.cdt = dtype
        self.fc_0 = _linear(size_in, size_h, generator)
        self.fc_1 = _linear(size_h, size_out, generator, zero=True)
        self.shortcut = None
        if size_in != size_out:
            self.shortcut = _linear(size_in, size_out, generator, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = activation(self.beta)
        net = dense(act(x), self.fc_0, self.cdt)
        dx = dense(act(net), self.fc_1, self.cdt)
        x_s = x if self.shortcut is None else dense(x, self.shortcut, self.cdt)
        return x_s + dx


class ResnetFC(nn.Module):
    def __init__(self, d_in: int, d_out: int = 4, n_blocks: int = 5,
                 d_latent: int = 0, d_hidden: int = 128, beta: float = 0.0,
                 combine_layer: int = 1000, combine_type: str = "average",
                 use_spade: bool = False, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if use_spade:
            raise NotImplementedError(
                "SPADE is not ported yet (ROADMAP.md Queue 1 item 19)"
            )
        self.d_in = d_in
        self.d_out = d_out
        self.n_blocks = n_blocks
        self.d_latent = d_latent
        self.d_hidden = d_hidden
        self.beta = beta
        self.combine_layer = combine_layer
        self.combine_type = combine_type
        self.use_spade = use_spade
        self.cdt = dtype
        g = generator
        self.lin_in = _linear(d_in, d_hidden, g) if d_in > 0 else None
        self.lin_out = _linear(d_hidden, d_out, g)
        self.blocks = nn.ModuleList(
            ResnetBlockFC(d_hidden, beta=beta, dtype=dtype, generator=g)
            for _ in range(n_blocks)
        )
        n_lin_z = min(combine_layer, n_blocks) if d_latent > 0 else 0
        self.lin_z = nn.ModuleList(
            _linear(d_latent, d_hidden, g) for _ in range(n_lin_z)
        )

    def forward(self, zx: torch.Tensor, combine_inner_dims=(1,)) -> torch.Tensor:
        """:param zx (..., d_latent + d_in), latent first
        :param combine_inner_dims (NS, B): at combine_layer the rows are
          reshaped (-1, NS, B, H) and averaged over NS
        :return (..., d_out) f32, the leading dim divided by NS if combined
        """
        cdt = self.cdt
        zx = zx.to(cdt)
        z = zx[..., : self.d_latent] if self.d_latent > 0 else None
        x = zx[..., self.d_latent:]
        if self.d_in > 0:
            x = dense(x, self.lin_in, cdt)
        else:
            x = torch.zeros(zx.shape[:-1] + (self.d_hidden,), dtype=cdt,
                            device=zx.device)
        for blkid in range(self.n_blocks):
            if blkid == self.combine_layer:
                x = combine_interleaved(x, combine_inner_dims,
                                        self.combine_type)
            if self.d_latent > 0 and blkid < self.combine_layer:
                x = x + dense(z, self.lin_z[blkid], cdt)
            x = self.blocks[blkid](x)
        return dense(activation(self.beta)(x).float(), self.lin_out,
                     torch.float32)

    @classmethod
    def from_conf(cls, conf, d_in: int, d_latent: int = 0, **kwargs):
        return cls(
            d_in,
            d_out=conf.get_int("d_out", 4),
            n_blocks=conf.get_int("n_blocks", 5),
            d_latent=d_latent,
            d_hidden=conf.get_int("d_hidden", 128),
            beta=conf.get_float("beta", 0.0),
            combine_layer=conf.get_int("combine_layer", 1000),
            combine_type=conf.get_string("combine_type", "average"),
            use_spade=conf.get_bool("use_spade", False),
            **kwargs,
        )
