"""Ray-sharded rendering: ``RenderParallel`` and ``bind_parallel``.

Counterpart of ``RenderParallel`` / ``bind_parallel`` in
pixelnerf_yolo_tpu/parallel/__init__.py.  The rays are padded (edge
padding) to a multiple of the ray-sharding extent, every mesh axis but
'model' (``parallel.n_shards``); the draws are made over the padded global
batch, as JAX's jitted render makes them; each rank renders its slice of
rays with its slice of the draws, launching the field kernels on it; the
slices are all-gathered over the ray-sharding group and trimmed.  The
ranks of a 'model' group render the same rays through the split field.
On a mesh of one shard (or none) the renderer is called as it is.
"""

from __future__ import annotations

import torch

from . import (_pad_to_multiple, default_mesh, mesh_group, n_shards,
               ray_axes, shard_draws, shard_index)
from .collectives import gather_along


class RenderParallel:
    """Mesh-sharded renderer binding.

    NeRF: rays (SB, B, 8) sharded on B; returns the renderer's output dict,
    or (rgb, depth) of the fine pass (coarse without one) with
    simple_output.  YOLO: rays (B, 8) or (1, B, 8) sharded on B; returns
    (B, A, 7).  ``train`` renders with autograd (and, NeRF, the training
    draws and sigma noise)."""

    def __init__(self, renderer, model, mesh=None,
                 simple_output: bool = False, want_weights: bool = False,
                 train: bool = False):
        self.renderer = renderer
        self.model = model
        self.mesh = mesh
        self.simple_output = simple_output
        self.want_weights = want_weights
        self.train = train
        self.is_yolo = not hasattr(renderer, "using_fine")
        self.group = (mesh_group(mesh, ray_axes(mesh))
                      if mesh is not None else None)

    @property
    def n_shards(self) -> int:
        """The ray-sharding extent: every mesh axis except 'model'."""
        return n_shards(self.mesh)

    def __call__(self, cond, rays, generator=None, draws=None):
        """:param draws NeRF: optional draws as ``renderer.draw`` makes
          them over the padded global batch (SB x the chunk-padded count of
          the mesh-padded rays); YOLO: optional (B_padded, n_coarse)
          uniforms over the mesh-padded rays"""
        if self.is_yolo:
            return self._yolo(cond, rays, generator, draws)
        return self._nerf(cond, rays, generator, draws)

    def _yolo(self, cond, rays, generator, u):
        r = self.renderer
        rays = torch.as_tensor(rays, dtype=torch.float32,
                               device=r.device).reshape(-1, 8)
        if rays.shape[0] == 0:
            return torch.zeros((0, r.num_anchors_per_scale, 7),
                               dtype=rays.dtype, device=rays.device)
        fn = r.render if self.train else r
        ns = self.n_shards
        if ns == 1:
            return fn(self.model, cond, rays, generator=generator, u=u)
        rays_p, n = _pad_to_multiple(rays, 0, ns)
        if u is None:
            u = torch.rand((rays_p.shape[0], r.n_coarse),
                           generator=generator, device=rays.device)
        L = rays_p.shape[0] // ns
        sl = slice(shard_index(self.mesh) * L, (shard_index(self.mesh) + 1)
                   * L)
        u = shard_draws(u, (), sl, device=rays.device)
        out = fn(self.model, cond, rays_p[sl], u=u)
        return gather_along(out, 0, self.group)[:n]

    def _nerf(self, cond, rays, generator, draws):
        r = self.renderer
        rays = torch.as_tensor(rays, dtype=torch.float32, device=r.device)
        if rays.shape[0] == 0 or rays.shape[1] == 0:
            return (torch.zeros((0, 3), dtype=rays.dtype, device=rays.device),
                    torch.zeros((0,), dtype=rays.dtype, device=rays.device))
        want = self.want_weights and not self.simple_output
        fn = r.render if self.train else r.__call__
        kw = {"train": True} if self.train else {}
        ns = self.n_shards
        if ns == 1:
            out = fn(self.model, cond, rays, generator=generator, draws=draws,
                     want_weights=want, **kw)
        else:
            rays_p, n = _pad_to_multiple(rays, 1, ns)
            sb, Bp = rays_p.shape[:2]
            if draws is None:
                draws = r.batch_draws(
                    sb, Bp, cond, generator, rays.device, train=self.train,
                    grad_remat=self.train and torch.is_grad_enabled()
                    and getattr(self.model, "remat", False))
            L = Bp // ns
            s = shard_index(self.mesh)
            sl = slice(s * L, (s + 1) * L)
            out = fn(self.model, cond, rays_p[:, sl],
                     draws=shard_draws(draws, (sb,), sl,
                                       device=rays.device),
                     want_weights=want, **kw)
            out = {p: {k: gather_along(v, 1, self.group)[:, :n]
                       for k, v in d.items()} for p, d in out.items()}
        if self.simple_output:
            branch = "fine" if r.using_fine else "coarse"
            return out[branch]["rgb"], out[branch]["depth"]
        return out


def bind_parallel(renderer, model, gpus=None, simple_output: bool = False,
                  mesh=None, want_weights: bool = True,
                  train: bool = False) -> RenderParallel:
    """The reference's --gpu_id binding: with a process group of several
    ranks and no mesh given, rays shard over a ("rays",) mesh of
    len(gpus) ranks (every rank calls this); one id, or no process group,
    renders unsharded."""
    if mesh is None and gpus is not None and len(gpus) > 1:
        mesh = default_mesh()
        if mesh is not None:
            print("Using multi-device ray sharding", mesh)
    return RenderParallel(renderer, model, mesh=mesh,
                          simple_output=simple_output,
                          want_weights=want_weights, train=train)
