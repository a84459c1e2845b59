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

Each block's output is the save point of the "block" remat policy
(``block_out``); the fused kernels have none.

Serving modes: ``forward(latent_projected=True)`` takes the latent part
already projected through the lin_z weights (the model pre-projects the
latent table) and adds each block's lin_z bias after the gather;
``int8=True`` runs lin_z, fc_0, fc_1 and the shortcut through the dynamic
int8 product (nn/quant.py), lin_in and lin_out in float.  SPADE
(``use_spade``) scales the residual stream per block by ``scale_z.N`` of
the latent before adding ``lin_z.N``'s injection.

Tensor parallelism (``parallel.shard_model``): a block bound to a 'model'
group of TP ranks holds H/TP of fc_0's output columns (and of its bias)
and H/TP of fc_1's input rows; its input enters through Megatron's f
(identity forward, all-reduce backward) and fc_1's partial product leaves
through g (all-reduce forward) before fc_1's bias and the residual add.
lin_in, lin_z, lin_out and the residual stream stay whole.  Unbound
(``tp_group`` None) f and g are the identity: one code path, the
single-device numbers.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import (copy_to_group, group_size,
                                    reduce_from_group)
from ..utils.indexing import combine_interleaved
from ..utils.profiling import scope
from .quant import dot_w8a8


def dense(x: torch.Tensor, m: nn.Linear, cdt: torch.dtype,
          int8: bool = False, wide: bool = False) -> torch.Tensor:
    """flax's Dense in the compute dtype; with int8 the dynamic int8
    product, its f32 bias, then one cast (JAX ``apply_dense``).  ``wide``
    takes the product in f32 (``_WideLinear``), so that its input gradient
    is f32 too, and rounds it once before the bias."""
    if int8:
        y = dot_w8a8(x.to(cdt), m.weight.t())
        if m.bias is not None:
            y = y + m.bias
        return y.to(cdt)
    y = dense_nobias(x, m, cdt, wide=wide).to(cdt)
    if m.bias is not None:
        y = y + m.bias.to(cdt)
    return y


def dense_nobias(x: torch.Tensor, m: nn.Linear, cdt: torch.dtype,
                 int8: bool = False, wide: bool = False) -> torch.Tensor:
    """``dense`` without the bias or the rounding: a row-parallel shard's
    partial product, in f32 when ``wide`` (int8: in f32, as ``dense``
    keeps it until the bias)."""
    if int8:
        return dot_w8a8(x.to(cdt), m.weight.t())
    if wide:
        return _WideLinear.apply(x, m.weight.to(cdt))
    return F.linear(x.to(cdt), m.weight.to(cdt))


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of compute-dtype matrices with an f32 result: on the card one
    GEMM of the compute-dtype operands that writes f32 (``torch.mm``'s
    ``out_dtype``: the tensor cores, f32 accumulation), elsewhere the f32
    product of the same values."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class _WideLinear(torch.autograd.Function):
    """x @ w.T of compute-dtype values (x may be f32 holding them) with an
    f32 result and an f32 input gradient: the partial products a split
    block sums over ranks.  Its caller rounds the result to the compute
    dtype, so the incoming gradient holds compute-dtype values and is
    taken in that dtype exactly; the weight gradient is rounded to w's
    dtype, as F.linear's is."""

    @staticmethod
    def forward(ctx, x, w):
        x2 = x.reshape(-1, x.shape[-1]).to(w.dtype)
        ctx.save_for_backward(x2, w)
        ctx.lead = x.shape[:-1]
        return _mm_f32(x2, w.t()).reshape(*ctx.lead, w.shape[0])

    @staticmethod
    def backward(ctx, gy):
        x2, w = ctx.saved_tensors
        g = gy.reshape(-1, gy.shape[-1]).to(w.dtype)
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = _mm_f32(g, w).reshape(*ctx.lead, w.shape[1])
        if ctx.needs_input_grad[1]:
            gw = _mm_f32(g.t(), x2).to(w.dtype)
        return gx, gw


class _BlockOut(threading.local):
    """``keep`` while a selective checkpoint that keeps the block outputs
    runs its forward or its recompute; ``marking`` while ``block_out``
    copies one (the policy tells that copy from every other op)."""

    keep = False
    marking = False


_block_out = _BlockOut()


def _keep_block_out(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if _block_out.marking
            else CheckpointPolicy.PREFER_RECOMPUTE)


@contextlib.contextmanager
def _keeping(ctx):
    old = _block_out.keep
    _block_out.keep = True
    try:
        with ctx:
            yield
    finally:
        _block_out.keep = old


def block_out_contexts():
    """The (forward, recompute) contexts of a selective checkpoint that
    keeps each ResnetFC block's output (``model.remat_policy = block``)."""
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    fwd, rec = create_selective_checkpoint_contexts(_keep_block_out)
    return _keeping(fwd), _keeping(rec)


def block_out(x: torch.Tensor) -> torch.Tensor:
    """A block's output x: under ``block_out_contexts`` a copy that the
    checkpoint keeps, else x itself (JAX ``checkpoint_name(x,
    "block_out")``)."""
    if not _block_out.keep:
        return x
    _block_out.marking = True
    try:
        return x.clone()
    finally:
        _block_out.marking = False


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
    zero-initialized so a fresh block is the identity.  ``tp_group``: the
    'model' group its fc_0 / fc_1 shards are split over (module doc)."""

    tp_group = None

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

    def forward(self, x: torch.Tensor, int8: bool = False) -> torch.Tensor:
        with scope("resblock"):
            return self._block(x, int8)

    def _block(self, x: torch.Tensor, int8: bool) -> torch.Tensor:
        act = activation(self.beta)
        cdt, group = self.cdt, self.tp_group
        # split over ranks, the partial products (fc_1's; fc_0's input
        # gradient, summed by f's backward) are f32 and rounded once after
        # the sum, as XLA (its CPU lowering) sums a bf16 product split over
        # 'model'.  With no group (or one rank) f and g are the identity,
        # wide is off, and this is dense(act(dense(act(x), fc_0)), fc_1):
        # the same rounding points.  int8's partial products are f32
        # already.
        wide = group_size(group) > 1 and not int8 and cdt != torch.float32
        h = act(x)
        net = dense(copy_to_group(h.float() if wide else h, group),
                    self.fc_0, cdt, int8, wide=wide)
        total = reduce_from_group(
            dense_nobias(act(net), self.fc_1, cdt, int8, wide=wide), group)
        dx = ((total + self.fc_1.bias).to(cdt) if int8
              else total.to(cdt) + self.fc_1.bias.to(cdt))
        x_s = x if self.shortcut is None else dense(x, self.shortcut,
                                                    self.cdt, int8)
        return x_s + dx


class ResnetFC(nn.Module):
    # the 'model' group its blocks are split over (``parallel.shard_model``)
    tp_group = None

    def __init__(self, d_in: int, d_out: int = 4, n_blocks: int = 5,
                 d_latent: int = 0, d_hidden: int = 128, beta: float = 0.0,
                 combine_layer: int = 1000, combine_type: str = "average",
                 use_spade: bool = False, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
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
        if use_spade:
            self.scale_z = nn.ModuleList(
                _linear(d_latent, d_hidden, g) for _ in range(n_lin_z)
            )

    @property
    def n_lin_z(self) -> int:
        return len(self.lin_z)

    def forward(self, zx: torch.Tensor, combine_inner_dims=(1,),
                latent_projected: bool = False,
                int8: bool = False) -> torch.Tensor:
        """:param zx (..., d_latent + d_in), latent first; with
          latent_projected the latent part is n_lin_z * d_hidden wide, the
          gathered rows of the table projected through the lin_z weights
        :param combine_inner_dims (NS, B): at combine_layer the rows are
          reshaped (-1, NS, B, H) and averaged over NS
        :param int8 the hidden layers through the dynamic int8 product
        :return (..., d_out) f32, the leading dim divided by NS if combined
        """
        with scope("resnetfc_infer"):
            return self._infer(zx, combine_inner_dims, latent_projected,
                               int8)

    def _infer(self, zx, combine_inner_dims, latent_projected, int8):
        cdt = self.cdt
        zx = zx.to(cdt)
        d_lat = (self.n_lin_z * self.d_hidden if latent_projected
                 else self.d_latent)
        z = zx[..., :d_lat] if d_lat > 0 else None
        x = zx[..., d_lat:]
        if self.d_in > 0:
            x = dense(x, self.lin_in, cdt)
        else:
            x = torch.zeros(zx.shape[:-1] + (self.d_hidden,), dtype=cdt,
                            device=zx.device)
        # JAX's merged injection (one product over the concatenated lin_z
        # weights): the same rounding points as the per-block form, except
        # under int8, where it quantizes the compute-dtype weights and adds
        # the compute-dtype biases; it is taken on >= 2^17 rows, as in JAX
        tz_all = bz = None
        n_rows = zx.numel() // zx.shape[-1]
        if (z is not None and self.n_lin_z > 0 and not self.use_spade
                and (latent_projected or (int8 and n_rows >= 1 << 17))):
            bz = torch.cat([m.bias for m in self.lin_z]).to(cdt)
            if latent_projected:
                tz_all = z  # each block's bias is added after the gather
            else:
                wz = torch.cat([m.weight for m in self.lin_z]).to(cdt)
                tz_all = (dot_w8a8(z, wz.t()) + bz).to(cdt)
        H = self.d_hidden
        for blkid in range(self.n_blocks):
            if blkid == self.combine_layer:
                x = combine_interleaved(x, combine_inner_dims,
                                        self.combine_type)
            if self.d_latent > 0 and blkid < self.combine_layer:
                if tz_all is not None:
                    tz = tz_all[..., blkid * H:(blkid + 1) * H]
                    if latent_projected:
                        tz = tz + bz[blkid * H:(blkid + 1) * H]
                    x = x + tz
                else:
                    tz = dense(z, self.lin_z[blkid], cdt, int8)
                    if self.use_spade:
                        sz = dense(z, self.scale_z[blkid], cdt, int8)
                        x = sz * x + tz
                    else:
                        x = x + tz
            x = block_out(self.blocks[blkid](x, int8))
        return dense(activation(self.beta)(x).float(), self.lin_out,
                     torch.float32)

    @classmethod
    def from_conf(cls, conf, d_in: int, d_latent: int = 0, **kwargs):
        """A YOLO head (``yolo = True``) emits d_out values per anchor."""
        d_out = conf.get_int("d_out", 4)
        if conf.get_bool("yolo", False):
            d_out = conf.get_int("d_out", 7) * conf.get_int(
                "num_anchors_per_scale", 3)
        return cls(
            d_in,
            d_out=d_out,
            n_blocks=conf.get_int("n_blocks", 5),
            d_latent=d_latent,
            d_hidden=conf.get_int("d_hidden", 128),
            beta=conf.get_float("beta", 0.0),
            combine_layer=conf.get_int("combine_layer", 1000),
            combine_type=conf.get_string("combine_type", "average"),
            use_spade=conf.get_bool("use_spade", False),
            **kwargs,
        )
