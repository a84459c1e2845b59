"""YOLO ray renderer: stratified coarse samples, then a probability-
weighted aggregation over each ray's samples.

Counterpart of pixelnerf_yolo_tpu/render/yolo.py.  The draws are made once
over the whole batch, so the result does not depend on the chunk size; a
Python loop over chunks of rays takes the place of the JAX package's
``lax.map`` and aggregates over the samples inside each chunk.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.composite import yolo_aggregate
from ..ops.ray_sampling import sample_coarse
from ..utils.profiling import scope
from .nerf import _tensor


@dataclasses.dataclass(frozen=True)
class YoloRenderer:
    n_coarse: int = 128
    eval_batch_size: int = 1024
    num_anchors_per_scale: int = 3
    # "max" is the reference's max-sigmoid; "soft_count" and "gated_count"
    # squash the objectness mass (ops/composite.yolo_aggregate)
    aggregation: str = "max"
    agg_soft_count: float = 4.0
    agg_gamma: float = 1.0
    device: str = "cuda"

    @classmethod
    def from_conf(cls, conf, device="cuda") -> "YoloRenderer":
        """Reads the ROOT config (renderer.* and model.mlp_coarse.*)."""
        return cls(
            n_coarse=conf.get_int("renderer.n_coarse", 128),
            eval_batch_size=conf.get_int("renderer.eval_batch_size", 1024),
            num_anchors_per_scale=conf.get_int(
                "model.mlp_coarse.num_anchors_per_scale", 3),
            aggregation=conf.get_string("renderer.aggregation", "max"),
            agg_soft_count=conf.get_float("renderer.agg_soft_count", 4.0),
            agg_gamma=conf.get_float("renderer.agg_gamma", 1.0),
            device=device,
        )

    def chunk_rays_for(self, n_rays_per_scene: int, n_views: int = 1,
                       latent_width: int = 512, sb: int = 1) -> int:
        """Rays per scene and chunk: a budget of ~2M field rows (rows =
        rays x samples x source views x scenes) at 512-wide latents,
        scaled down for wider ones; eval_batch_size only raises it."""
        K = self.n_coarse
        ns = max(n_views, 1)
        budget = (1 << 21) * 512 // max(latent_width, 512)
        rows_budget = max(self.eval_batch_size * ns * K, budget)
        return max(1, rows_budget // max(K * ns * max(sb, 1), 1))

    def bind_parallel(self, *args, **kwargs):
        """``parallel.render.bind_parallel`` on this renderer."""
        from ..parallel.render import bind_parallel

        return bind_parallel(self, *args, **kwargs)

    @torch.no_grad()
    def __call__(self, model, cond, rays, generator=None, u=None):
        """Render detections along rays, for inference (no autograd graph).

        :param rays (B, 8) or (SB, B, 8), moved to the renderer's device
        :param generator torch.Generator for the coarse draws
        :param u optional (SB*B, n_coarse) uniform draws, scene-major
        :return (B, A, 7) or (SB, B, A, 7) = [prob, x, y, w, h, c0, c1]
        """
        return self.render(model, cond, rays, generator=generator, u=u)

    def render(self, model, cond, rays, generator=None, u=None):
        """``__call__`` with autograd: the training render."""
        with scope("yolo_render"):
            rays = _tensor(rays, self.device)
            scene_axis = rays.ndim == 3
            if not scene_axis:
                rays = rays.reshape(1, -1, 8)
            SB, B = rays.shape[:2]
            A, K = self.num_anchors_per_scale, self.n_coarse
            if u is None:
                u = torch.rand((SB * B, K), generator=generator,
                               device=rays.device)
            z = sample_coarse(rays.reshape(-1, 8), K,
                              u=_tensor(u, rays.device)).reshape(SB, B, K)

            cb = self.chunk_rays_for(B, cond.num_views_per_obj,
                                     cond.latent_flat.shape[-1], SB)
            nc = -(-B // cb)
            cb = -(-B // nc)
            pad = nc * cb - B
            if pad:  # pad with each scene's first ray
                rays = torch.cat([rays, rays[:, :1].expand(SB, pad, 8)], dim=1)
                z = torch.cat([z, z[:, :1].expand(SB, pad, K)], dim=1)

            chunks = []
            for start in range(0, nc * cb, cb):
                r = rays[:, start:start + cb, None]  # (SB, cb, 1, 8)
                pts = (r[..., :3]
                       + z[:, start:start + cb, :, None] * r[..., 3:6])
                vd = r[..., 3:6].expand(SB, cb, K, 3)
                out = model.forward(cond, pts.reshape(SB, cb * K, 3),
                                    coarse=True,
                                    viewdirs=vd.reshape(SB, cb * K, 3))
                with scope("yolo_aggregate"):
                    agg = yolo_aggregate(out.reshape(SB * cb, K, A, 7),
                                         mode=self.aggregation,
                                         soft_count=self.agg_soft_count,
                                         gamma=self.agg_gamma)
                chunks.append(agg.reshape(SB, cb, A, 7))
            out = torch.cat(chunks, dim=1)[:, :B]
            return out if scene_axis else out[0]
