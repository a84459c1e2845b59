"""Multi-device parallelism: one process per device, a named device mesh,
and the tensor-parallel split of the field MLP.

Counterpart of pixelnerf_yolo_tpu/parallel/__init__.py.  JAX runs one
process that shards arrays over a ``jax.sharding.Mesh``; the port runs one
process per device (``torch.distributed``: NCCL where each rank owns a
card, gloo on the CPU or where ranks share a card) and names its ranks
with a ``torch.distributed.device_mesh.DeviceMesh`` of JAX's axis names:

  make_mesh        ("rays",)                     render sharding
  make_train_mesh  ("data", "rays"[, "model"])   training

Every rank builds the same global batch and the same global draws and
takes its part by its mesh coordinate (``shard_index``), so the numbers
are those of JAX's sharded program.  ``tp_plan`` names the parameters
that shard over "model" (the counterpart of ``tp_shardings``),
``shard_model`` splits them and ``full_state_dict`` gathers them back
into the single-device layout.  ``render.bind_parallel`` shards a
renderer's rays; ``launch`` starts the ranks of an entry point.
"""

from __future__ import annotations

import os
import sys
import tempfile
from typing import Optional

import torch
import torch.distributed as dist

from . import collectives

RAY_AXIS = "rays"
DATA_AXIS = "data"
MODEL_AXIS = "model"


# -- process groups ------------------------------------------------------------


def backend_for(device: str, gpu_ids) -> str:
    """nccl when every rank owns a CUDA device of its own; gloo on the CPU
    and where ranks share a card (NCCL refuses two ranks on one device)."""
    if str(device).startswith("cuda") and len(set(gpu_ids)) == len(gpu_ids):
        return "nccl"
    return "gloo"


def rank_device(device: str, gpu_ids, rank: int) -> str:
    """Rank r's device: cuda:<gpu_ids[r]>, or the CPU."""
    if str(device).startswith("cuda"):
        return f"cuda:{gpu_ids[rank]}"
    return "cpu"


def init_process_group(rank: int, world_size: int, device: str, gpu_ids,
                       store: str) -> str:
    """Join the ranks through a ``file://`` store; returns the rank's device.
    A rank given a card that the machine lacks fails here."""
    dev = rank_device(device, gpu_ids, rank)
    if dev.startswith("cuda"):
        torch.cuda.set_device(torch.device(dev))
    backend = backend_for(device, gpu_ids)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world_size)
    if rank == 0 and world_size > 1:
        staged = " (CUDA tensors staged through the host)" if (
            backend == "gloo" and dev.startswith("cuda")) else ""
        print(f"process group: {world_size} ranks over {backend}{staged}",
              flush=True)
    return dev


def destroy_process_group() -> None:
    _groups.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    """Whether this process prints, logs and writes files."""
    return rank() == 0


# -- meshes --------------------------------------------------------------------


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh():
    """1-D DeviceMesh ("rays",) over every rank."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_device_type(), (world_size(),),
                            mesh_dim_names=(RAY_AXIS,))


def default_mesh():
    """``make_mesh()`` of this process group, made once (every rank calls
    it together the first time), or None on one device."""
    if world_size() == 1:
        return None
    if "default" not in _groups:
        _groups["default"] = make_mesh()
    return _groups["default"]


def train_mesh_shape(n_devices: int, batch_size: int = 1,
                     model_parallel: int = 1) -> dict:
    """{axis: size} of ``make_train_mesh``: 'data' the largest divisor of
    the data-parallel device count that divides batch_size, 'rays' the
    rest, 'model' (innermost, only when > 1) model_parallel."""
    n = int(n_devices)
    tp = max(int(model_parallel), 1)
    if n % tp != 0:
        raise ValueError(
            f"model_parallel={tp} must divide the device count {n}")
    n_dp = n // tp
    data = 1
    for d in range(min(n_dp, max(batch_size, 1)), 0, -1):
        if n_dp % d == 0 and batch_size % d == 0:
            data = d
            break
    shape = {DATA_AXIS: data, RAY_AXIS: n_dp // data}
    if tp > 1:
        shape[MODEL_AXIS] = tp
    return shape


def make_train_mesh(n_devices: Optional[int] = None, batch_size: int = 1,
                    model_parallel: int = 1):
    """('data', 'rays'[, 'model']) DeviceMesh over every rank
    (``train_mesh_shape``): scenes shard over 'data', rays over 'rays', the
    field MLP's hidden dimension over 'model', the innermost axis."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = train_mesh_shape(n_devices or world_size(), batch_size,
                             model_parallel)
    mesh = init_device_mesh(_device_type(), tuple(shape.values()),
                            mesh_dim_names=tuple(shape))
    mesh_group(mesh, ray_axes(mesh))  # every rank makes the group now
    return mesh


def axis_size(mesh, axis: str) -> int:
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 0
    return mesh.get_coordinate()[mesh.mesh_dim_names.index(axis)]


def ray_axes(mesh) -> tuple:
    """Every axis but 'model': the ray-sharding axes (JAX ``n_shards``)."""
    if mesh is None:
        return ()
    return tuple(a for a in mesh.mesh_dim_names if a != MODEL_AXIS)


def n_shards(mesh, axes=None) -> int:
    axes = ray_axes(mesh) if axes is None else axes
    n = 1
    for a in axes:
        n *= axis_size(mesh, a)
    return n


def shard_index(mesh, axes=None) -> int:
    """This rank's row-major index over axes (default ``ray_axes``)."""
    axes = ray_axes(mesh) if axes is None else axes
    i = 0
    for a in axes:
        i = i * axis_size(mesh, a) + axis_index(mesh, a)
    return i


_groups: dict = {}


def mesh_group(mesh, axes):
    """The process group of the ranks that differ only along axes (None
    for no mesh).  Several axes flatten into one group, made by every rank
    at its first request."""
    if mesh is None:
        return None
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    ranks = mesh.mesh
    key = (tuple(ranks.flatten().tolist()), tuple(ranks.shape), axes)
    if key not in _groups:
        names = mesh.mesh_dim_names
        keep = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in keep]
        grid = ranks.permute(*rest, *keep).reshape(-1, n_shards(mesh, axes))
        mine = None
        for row in grid.tolist():
            g = dist.new_group(row)
            if dist.get_rank() in row:
                mine = g
        _groups[key] = mine
    return _groups[key]


# -- tensor parallelism --------------------------------------------------------


def _tp_dim(name: str, ndim: int) -> Optional[int]:
    if ndim == 2 and name.endswith("fc_0.weight"):
        return 0
    if ndim == 1 and name.endswith("fc_0.bias"):
        return 0
    if ndim == 2 and name.endswith("fc_1.weight"):
        return 1
    return None


def tp_plan(named_shapes, tp: int) -> dict:
    """{name: the dimension it shards on over 'model', or None} for a
    state_dict's (or an optimizer state's) names and shapes, in the torch
    layout (weight (out, in)):

      ``fc_0.weight``  dim 0, column-parallel (JAX fc_0/kernel P(None, model))
      ``fc_0.bias``    dim 0                  (JAX fc_0/bias P(model))
      ``fc_1.weight``  dim 1, row-parallel    (JAX fc_1/kernel P(model, None))

    and None for everything else (replicated).  tp == 1 shards nothing."""
    plan = {}
    for name, shape in named_shapes:
        dim = _tp_dim(name, len(shape)) if tp > 1 else None
        if dim == 0 and len(shape) == 2 and shape[0] % tp:
            raise ValueError(
                f"d_hidden {shape[0]} not divisible by model_parallel "
                f"{tp} ({name})")
        plan[name] = dim
    return plan


def _field_mlps(model):
    from ..nn.resnetfc import ResnetFC

    return [m for m in (getattr(model, "mlp_coarse", None),
                        getattr(model, "mlp_fine", None))
            if isinstance(m, ResnetFC)]


def shard_model(model, mesh) -> None:
    """Split the field MLPs' fc_0 / fc_1 over the mesh's 'model' axis in
    place (``tp_plan``) and bind their blocks to its group; the rest stays
    whole.  No 'model' axis: nothing changes."""
    tp = axis_size(mesh, MODEL_AXIS)
    if tp == 1:
        return
    group = mesh.get_group(MODEL_AXIS)
    r = axis_index(mesh, MODEL_AXIS)
    plan = tp_plan(((n, p.shape) for n, p in model.named_parameters()), tp)
    with torch.no_grad():
        for name, p in model.named_parameters():
            dim = plan[name]
            if dim is not None:
                size = p.shape[dim] // tp
                p.data = p.data.narrow(dim, r * size, size).contiguous()
    for mlp in _field_mlps(model):
        mlp.tp_group = group
        for blk in mlp.blocks:
            blk.tp_group = group


def model_group(model):
    """The 'model' group the field MLPs of model are bound to, or None."""
    mlps = _field_mlps(model)
    return getattr(mlps[0], "tp_group", None) if mlps else None


def gather_tp(t: torch.Tensor, dim: Optional[int], group) -> torch.Tensor:
    """A shard of ``tp_plan``'s dim gathered whole over group."""
    if dim is None or collectives.group_size(group) == 1:
        return t
    return torch.cat(collectives.all_gather(t, group), dim=dim)


def full_state_dict(model) -> dict:
    """The model's state_dict in the single-device layout: the
    tensor-parallel shards gathered (a collective over the 'model' group;
    every rank calls it)."""
    state = model.state_dict()
    group = model_group(model)
    if collectives.group_size(group) == 1:
        return state
    return {k: gather_tp(v, _tp_dim(k, v.ndim), group)
            for k, v in state.items()}


def _adam_moments(state: dict, model):
    """(parameter name, its Adam state) pairs of an optimizer state_dict
    over model.parameters()."""
    names = [n for n, _ in model.named_parameters()]
    return [(names[i], s) for i, s in state["state"].items()]


def full_optimizer_state(optimizer, model) -> dict:
    """``optimizer.state_dict()`` with the moments of tensor-parallel
    parameters gathered, as a single-device run would save it."""
    state = optimizer.state_dict()
    group = model_group(model)
    if collectives.group_size(group) == 1:
        return state
    for name, s in _adam_moments(state, model):
        for k in ("exp_avg", "exp_avg_sq"):
            if k in s:
                s[k] = gather_tp(s[k], _tp_dim(name, s[k].ndim), group)
    return state


def shard_optimizer_state(state: dict, model) -> dict:
    """A single-device Adam state_dict cut to this rank's tensor-parallel
    shards (``full_optimizer_state`` undone)."""
    group = model_group(model)
    tp = collectives.group_size(group)
    if tp == 1:
        return state
    r = collectives.group_rank(group)
    for name, s in _adam_moments(state, model):
        for k in ("exp_avg", "exp_avg_sq"):
            dim = _tp_dim(name, s[k].ndim) if k in s else None
            if dim is not None:
                size = s[k].shape[dim] // tp
                s[k] = s[k].narrow(dim, r * size, size).contiguous()
    return state


def broadcast_module(model, src: int = 0) -> None:
    """Every rank takes rank src's parameters and buffers."""
    if world_size() == 1:
        return
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            collectives.broadcast_(t.data, src)


def _pad_to_multiple(x: torch.Tensor, axis: int, multiple: int):
    """x padded along axis to a multiple of ``multiple`` by repeating its
    last entry (edge padding); returns (padded, original length)."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    edge = x.narrow(axis, n - 1, 1)
    reps = [1] * x.ndim
    reps[axis] = rem
    return torch.cat([x, edge.repeat(*reps)], dim=axis), n


def shard_draws(draws, outer: tuple, rays_of: slice,
                scenes: slice = slice(None), device=None):
    """A rank's rows of global draws: each (rows, D) tensor (or each value
    of a dict of them) laid out as (*outer, rays, D), outer () or (scenes,
    ...), cut to [scenes, ..., rays_of] and flattened to (rows, D) f32.
    The ray count is the draws' own (NeRF's are chunk-padded)."""
    def cut(v):
        v = torch.as_tensor(v, dtype=torch.float32, device=device)
        v = v.reshape(*outer, -1, v.shape[-1])
        idx = (scenes, ..., rays_of, slice(None)) if outer else (rays_of,)
        return v[idx].reshape(-1, v.shape[-1])

    if isinstance(draws, dict):
        return {k: cut(v) for k, v in draws.items()}
    return cut(draws)


class BroadcastLoader:
    """A data loader whose batches rank 0 loads and every rank receives
    (``broadcast_object_list``): the ranks train on one global batch even
    where loading draws from unseeded generators (the train splits' color
    jitter), and only rank 0 reads the disk."""

    def __init__(self, loader):
        self.loader = loader

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader) if is_main() else None
        while True:
            box = [next(it, None) if it is not None else None]
            dist.broadcast_object_list(box, src=0)
            if box[0] is None:
                return
            yield box[0]


# -- starting the ranks ----------------------------------------------------------


def _importable(fn) -> tuple:
    """(module, name) of fn, the module named as the spawned ranks import
    it: a ``python -m`` entry point runs as ``__main__``."""
    module = fn.__module__
    if module == "__main__":
        module = sys.modules["__main__"].__spec__.name
    return module, fn.__qualname__


def _worker(rank, target, args, extra, world, store):
    import importlib

    if rank != 0:
        sys.stdout = open(os.devnull, "w")  # only rank 0 prints
    else:
        # the launcher's stdin (multiprocessing hands a child devnull)
        sys.stdin = open(0, closefd=False)
    fn = getattr(importlib.import_module(target[0]), target[1])
    args.device = init_process_group(rank, world, args.device, args.gpu_id,
                                     store)
    try:
        fn(args, *extra)
    finally:
        destroy_process_group()


def launch(fn, args, *extra):
    """Run ``fn(args, *extra)`` on the devices of ``args.gpu_id``.

    One id: in this process, unchanged.  Several: one process per id
    (``torch.multiprocessing.spawn``); rank r runs on
    cuda:<gpu_id[r]>, or on the CPU under ``--device cpu``, with
    ``args.device`` set to its device; the ranks join through a
    ``file://`` store in a temporary directory.  Under torchrun
    (WORLD_SIZE and RANK set) this process joins that group as its rank,
    on cuda:<gpu_id[LOCAL_RANK]> (or cuda:LOCAL_RANK when the list is
    shorter).  Returns fn's result on one device, else None."""
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ \
            and not dist.is_initialized():
        r = int(os.environ["RANK"])
        local = int(os.environ.get("LOCAL_RANK", r))
        ids = (list(args.gpu_id) if len(args.gpu_id) > local
               else list(range(local + 1)))
        dev = rank_device(args.device, ids, local)
        if dev.startswith("cuda"):
            torch.cuda.set_device(torch.device(dev))
        dist.init_process_group(backend_for(args.device, ids))
        if r != 0:
            sys.stdout = open(os.devnull, "w")  # only rank 0 prints
        args.device = dev
        try:
            return fn(args, *extra)
        finally:
            destroy_process_group()
    if len(args.gpu_id) == 1:
        return fn(args, *extra)
    import torch.multiprocessing as mp

    world = len(args.gpu_id)
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_worker, args=(_importable(fn), args, extra, world,
                                os.path.join(tmp, "store")),
                 nprocs=world, join=True)
    return None
