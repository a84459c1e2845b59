"""Plain MLP field (IGR-style geometric init, skip connections).

Counterpart of ``ImplicitNet`` in pixelnerf_yolo_tpu/nn/mlp.py, selected by
``mlp.type = mlp`` (the default of ``make_mlp``), with the reference's
module names ``lin0`` ... ``linN`` (the JAX package's ``lin_N``).  Always
f32, as in the JAX package, whatever the model's compute dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.indexing import combine_interleaved
from .resnetfc import activation


class ImplicitNet(nn.Module):
    """Linear layers of widths [d_in + d_latent, *dims, d_out], each but
    the last followed by ReLU (softplus(beta x) / beta when beta > 0).  A
    layer whose index + 1 is in ``skip_in`` outputs its width minus d_in,
    then appends ``zx[..., d_latent:]`` and divides by sqrt(2).  At
    ``combine_layer`` the rows are averaged over the source views.

    Init: the last layer normal with std sqrt(pi) / sqrt(its fan-in) and
    bias -radius_init when ``geometric_init``; every other layer normal
    with std sqrt(2 / fan-in) and bias 0."""

    def __init__(self, d_in: int, d_out: int = 4, dims=(128, 128, 128, 128),
                 skip_in=(), d_latent: int = 0, geometric_init: bool = True,
                 radius_init: float = 0.3, beta: float = 0.0,
                 combine_layer: int = 1000, combine_type: str = "average",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.d_in = d_in
        self.d_out = d_out
        self.d_latent = d_latent
        self.skip_in = tuple(skip_in)
        self.beta = beta
        self.combine_layer = combine_layer
        self.combine_type = combine_type
        widths = [d_in + d_latent] + list(dims) + [d_out]
        self.n_layers = len(widths) - 1
        for layer in range(self.n_layers):
            out_dim = widths[layer + 1]
            if layer + 1 in self.skip_in:
                out_dim -= d_in
            lin = nn.Linear(widths[layer], out_dim)
            with torch.no_grad():
                if geometric_init and layer == self.n_layers - 1:
                    lin.weight.normal_(0.0, math.sqrt(math.pi)
                                       / math.sqrt(widths[layer]),
                                       generator=generator)
                    lin.bias.fill_(-radius_init)
                else:
                    lin.weight.normal_(0.0, math.sqrt(2.0 / widths[layer]),
                                       generator=generator)
                    lin.bias.zero_()
            self.add_module(f"lin{layer}", lin)

    def forward(self, zx: torch.Tensor, combine_inner_dims=(1,)) -> torch.Tensor:
        """:param zx (..., d_latent + d_in), latent first -> (..., d_out)
        f32, the leading dim divided by NS if combined"""
        act = activation(self.beta)
        zx = zx.float()
        x = zx
        for layer in range(self.n_layers):
            if layer == self.combine_layer:
                x = combine_interleaved(x, combine_inner_dims,
                                        self.combine_type)
            lin = getattr(self, f"lin{layer}")
            x = F.linear(x, lin.weight, lin.bias)
            if layer + 1 in self.skip_in:
                x = torch.cat([x, zx[..., self.d_latent:]], dim=-1) \
                    / math.sqrt(2)
            if layer < self.n_layers - 1:
                x = act(x)
        return x

    @classmethod
    def from_conf(cls, conf, d_in: int, d_latent: int = 0, **kwargs):
        return cls(
            d_in,
            d_out=conf.get_int("d_out", 4),
            dims=tuple(conf.get_list("dims", [128, 128, 128, 128])),
            skip_in=tuple(conf.get_list("skip_in", [])),
            d_latent=d_latent,
            geometric_init=conf.get_bool("geometric_init", True),
            radius_init=conf.get_float("radius_init", 0.3),
            beta=conf.get_float("beta", 0.0),
            combine_layer=conf.get_int("combine_layer", 1000),
            combine_type=conf.get_string("combine_type", "average"),
            **kwargs,
        )
