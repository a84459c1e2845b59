"""Every collective of the port, differentiable where autograd needs it.

The tensor-parallel pair is Megatron's f and g:

  ``copy_to_group``      identity forward, all-reduce (sum) backward: the
                         input of a column-parallel layer, whose partial
                         input gradients sum over the group;
  ``reduce_from_group``  all-reduce (sum) forward, identity backward: the
                         output of a row-parallel layer.

``gather_along`` concatenates each rank's piece along a dimension (a
sharded render's outputs; its backward keeps the rank's own slice, since
what follows runs replicated), and ``gather_stats`` stacks each rank's
statistics (synchronised BatchNorm; its backward sums the gradient over
the group before keeping the rank's slice, since each rank's loss reads
every rank's statistics).

A group of one rank, or no group, makes each of them the identity, so a
single-device run computes what it computed before.  NCCL needs one device
per rank; where ranks share a card the group runs on gloo, which this
module hands CUDA tensors through the host (``staged``).
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist


def group_size(group) -> int:
    if group is None or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def group_rank(group) -> int:
    if group is None or not dist.is_initialized():
        return 0
    return dist.get_rank(group)


def staged(group, t: torch.Tensor) -> bool:
    """Whether a collective of t over group goes through the host: a CUDA
    tensor on a gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of t over group (no autograd)."""
    if group_size(group) == 1:
        return t
    if staged(group, t):
        h = t.detach().cpu()
        dist.all_reduce(h, op=op, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Each rank's t (same shapes), in group-rank order (no autograd)."""
    n = group_size(group)
    if n == 1:
        return [t]
    src = t.detach().contiguous()
    host = staged(group, src)
    if host:
        src = src.cpu()
    out = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(out, src, group=group)
    return [o.to(t.device) for o in out] if host else out


def broadcast_(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """In-place broadcast of t from global rank src over group."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return t
    if staged(group, t):
        h = t.detach().cpu()
        dist.broadcast(h, src, group=group)
        t.copy_(h)
    else:
        dist.broadcast(t, src, group=group)
    return t


def all_reduce_flat_(tensors: list[torch.Tensor], group) -> None:
    """All-reduce (sum) a list of tensors of one dtype and device in place
    through one flat buffer: one collective instead of one a tensor."""
    if group_size(group) == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_(flat, group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.n = dim, group, x.shape[dim]
        return torch.cat(all_gather(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        r = group_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.n, ctx.n), None, None


class _GatherStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return torch.stack(all_gather(x, group))

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone(), ctx.group)
        return g[group_rank(ctx.group)], None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: identity forward, all-reduce backward."""
    return x if group_size(group) == 1 else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: all-reduce forward, identity backward."""
    return x if group_size(group) == 1 else _ReduceFromGroup.apply(x, group)


def gather_along(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' x concatenated along dim in group-rank order; the
    backward keeps this rank's slice (what follows runs replicated)."""
    if group_size(group) == 1:
        return x
    return _GatherAlong.apply(x, dim, group)


def gather_stats(x: torch.Tensor, group) -> torch.Tensor:
    """(group size, *x.shape): every rank's x; the backward sums the
    gradient over the group, then keeps this rank's slice."""
    if group_size(group) == 1:
        return x[None]
    return _GatherStats.apply(x, group)


# -- synchronised BatchNorm --------------------------------------------------


class _BatchNormGroup(threading.local):
    group = None


_bn = _BatchNormGroup()


@contextlib.contextmanager
def synced_batch_norm(group):
    """Inside, train-mode BatchNorm (nn/resnet.py::batch_norm) takes its
    statistics over every rank of group (None: this rank's batch)."""
    old = _bn.group
    _bn.group = group if group_size(group) > 1 else None
    try:
        yield
    finally:
        _bn.group = old


def batch_norm_group():
    """The group of ``synced_batch_norm`` in force, or None."""
    return _bn.group
