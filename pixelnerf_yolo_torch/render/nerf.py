"""NeRF volume renderer.

Counterpart of pixelnerf_yolo_tpu/render/nerf.py.  Stratified coarse pass
-> composite -> fine pass over the union of coarse, importance and depth
samples, composited in sorted-z order.

The ray batch is split into chunks of ``_chunk_rays`` rays per scene, and a
Python loop runs coarse + fine for each chunk, as the JAX package's
``_render_chunked_fused`` does inside one ``lax.map`` body.  All random
draws are made once over the full (padded) batch, so the result does not
depend on the chunk size.  The fine pass evaluates the union in unsorted
order so that the coarse samples reuse their latents, then sorts.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops.composite import composite
from ..ops.ray_sampling import sample_coarse, sample_fine, sample_fine_depth


def _tensor(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, dtype=np.float32))
    return x.to(device=device, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class NeRFRenderer:
    n_coarse: int = 128
    n_fine: int = 0
    n_fine_depth: int = 0
    depth_std: float = 0.01
    eval_batch_size: int = 100000
    white_bkgd: bool = False
    lindisp: bool = False
    sched: Optional[tuple] = None  # (iters, n_coarse list, n_fine list)
    early_terminate: float = 0.0
    device: str = "cuda"

    def __post_init__(self):
        if self.early_terminate > 0.0:
            raise NotImplementedError(
                "renderer.early_terminate is not ported yet "
                "(ROADMAP.md Queue 1 item 19)"
            )

    @property
    def using_fine(self) -> bool:
        return self.n_fine > 0

    @classmethod
    def from_conf(cls, conf, white_bkgd=False, lindisp=False,
                  eval_batch_size=100000, device="cuda") -> "NeRFRenderer":
        sched = conf.get_list("sched", None)
        if sched is not None and len(sched) == 0:
            sched = None
        return cls(
            n_coarse=conf.get_int("n_coarse", 128),
            n_fine=conf.get_int("n_fine", 0),
            n_fine_depth=conf.get_int("n_fine_depth", 0),
            depth_std=conf.get_float("depth_std", 0.01),
            white_bkgd=bool(conf.get_float("white_bkgd", white_bkgd)),
            lindisp=lindisp,
            eval_batch_size=conf.get_int("eval_batch_size", eval_batch_size),
            sched=tuple(map(tuple, sched)) if sched is not None else None,
            early_terminate=conf.get_float("early_terminate", 0.0),
            device=device,
        )

    # -- internals -------------------------------------------------------

    def _chunk_rays(self, n_rays_per_scene: int, n_views: int = 1,
                    latent_width: int = 512) -> int:
        """Rays per chunk: a budget of ~2M field rows per chunk (rows =
        rays x the largest per-pass sample count x source views), scaled
        down for latents wider than 512; the conf's eval_batch_size only
        raises the budget.  Chunks are split evenly."""
        k_max = self.n_coarse + (self.n_fine if self.using_fine else 0)
        rows_per_ray = max(k_max, 1) * max(n_views, 1)
        budget = (1 << 21) * 512 // max(latent_width, 512)
        cap = max(1, max(self.eval_batch_size, budget) // rows_per_ray)
        if n_rays_per_scene <= cap:
            return n_rays_per_scene
        nc = -(-n_rays_per_scene // cap)
        return -(-n_rays_per_scene // nc)

    def draw(self, n_rows: int, generator: torch.Generator | None = None,
             device=None) -> dict:
        """The render's random draws for ``n_rows`` (padded) rays."""
        device = device or self.device
        n_imp = self.n_fine - self.n_fine_depth

        def rand(k, fn=torch.rand):
            return fn((n_rows, k), generator=generator, device=device)

        d = {"u_coarse": rand(self.n_coarse)}
        if self.using_fine and n_imp > 0:
            d["u"] = rand(n_imp)
            d["u_jitter"] = rand(n_imp)
        if self.using_fine and self.n_fine_depth > 0:
            d["noise_d"] = rand(self.n_fine_depth, torch.randn)
        return d

    def _eval_model(self, model, cond, rays, z_samp, coarse: bool, sb: int,
                    return_latent: bool = False):
        """Evaluate the field at all sample points of a chunk.

        rays (B, 8); z_samp (B, K).  Returns (B, K, d_out), and with
        return_latent also the (SB*NS, B*K/SB, C) latents for reuse.
        """
        B, K = z_samp.shape
        points = rays[:, None, :3] + z_samp[..., None] * rays[:, None, 3:6]
        pts = points.reshape(sb, -1, 3)
        vd = None
        if model.use_viewdirs:
            vd = rays[:, None, 3:6].expand(B, K, 3).reshape(sb, -1, 3)
        lat = model.project_latent(cond, pts)
        out = model.forward(cond, pts, coarse=coarse, viewdirs=vd, latent=lat)
        out = out.reshape(B, K, -1)
        return (out, lat) if return_latent else out

    def _composite_pass(self, model, cond, rays, z_samp, coarse, sb,
                        return_latent: bool = False):
        out = self._eval_model(model, cond, rays, z_samp, coarse, sb,
                               return_latent=return_latent)
        latent = None
        if return_latent:
            out, latent = out
        comp = composite(out, z_samp, rays[:, -1:], white_bkgd=self.white_bkgd)
        return (comp + (latent,)) if return_latent else comp

    def _fine_pass_reuse(self, model, cond, rays, z_union, k_coarse: int,
                         latent_c, sb):
        """Fine pass evaluated in unsorted union order, so that the first
        k_coarse samples reuse the coarse pass's latents; the outputs are
        then put in sorted-z order (stable sort) before compositing."""
        B, Ku = z_union.shape
        Kn = Ku - k_coarse
        Bp = B // sb
        z_new = z_union[:, k_coarse:]
        pts_new = rays[:, None, :3] + z_new[..., None] * rays[:, None, 3:6]
        lat_new = model.project_latent(cond, pts_new.reshape(sb, -1, 3))
        C = lat_new.shape[-1]
        lat_u = torch.cat(
            [latent_c.reshape(-1, Bp, k_coarse, C),
             lat_new.reshape(-1, Bp, Kn, C)], dim=2,
        ).reshape(-1, Bp * Ku, C)
        pts_u = rays[:, None, :3] + z_union[..., None] * rays[:, None, 3:6]
        vd = None
        if model.use_viewdirs:
            vd = rays[:, None, 3:6].expand(B, Ku, 3).reshape(sb, -1, 3)
        out = model.forward(cond, pts_u.reshape(sb, -1, 3), coarse=False,
                            viewdirs=vd, latent=lat_u).reshape(B, Ku, -1)
        z_sorted, perm = torch.sort(z_union, dim=-1, stable=True)
        out_sorted = torch.gather(
            out.float(), 1, perm[..., None].expand(-1, -1, out.shape[-1])
        )
        return composite(out_sorted, z_sorted, rays[:, -1:],
                         white_bkgd=self.white_bkgd)

    def _render_chunk(self, model, cond, rays, draws: dict, sb: int):
        """Coarse + fine for one chunk of rays (sb * cb, 8)."""
        z_c = sample_coarse(rays, self.n_coarse, lindisp=self.lindisp,
                            u=draws["u_coarse"])
        w_c, rgb_c, depth_c, lat = self._composite_pass(
            model, cond, rays, z_c, True, sb, return_latent=True
        )
        res = {"w_c": w_c, "rgb_c": rgb_c, "depth_c": depth_c}
        if not self.using_fine:
            return res
        samps = [z_c]
        if "u" in draws:
            samps.append(sample_fine(
                rays, w_c, self.n_fine - self.n_fine_depth, self.n_coarse,
                lindisp=self.lindisp, u=draws["u"], u_jitter=draws["u_jitter"],
            ))
        if "noise_d" in draws:
            samps.append(sample_fine_depth(
                rays, depth_c, self.n_fine_depth, depth_std=self.depth_std,
                noise=draws["noise_d"],
            ))
        res["w_f"], res["rgb_f"], res["depth_f"] = self._fine_pass_reuse(
            model, cond, rays, torch.cat(samps, dim=-1), self.n_coarse, lat,
            sb,
        )
        return res

    # -- public API --------------------------------------------------------

    @torch.no_grad()
    def __call__(self, model, cond, rays, generator=None, draws=None,
                 want_weights: bool = False) -> dict:
        """Render a ray batch.

        :param rays (SB, B, 8), moved to the renderer's device
        :param generator torch.Generator for the draws (default: torch's)
        :param draws optional pre-made draws, as ``draw`` returns them, over
          the padded batch (SB * B_padded rows, scene-major)
        :return {"coarse": {"rgb" (SB,B,3), "depth" (SB,B), ["weights"]},
                 ["fine": {...}]}
        """
        rays = _tensor(rays, self.device)
        if rays.ndim != 3:
            raise ValueError(f"rays must be (SB, B, 8), got {tuple(rays.shape)}")
        return self._render(model, cond, rays, generator, draws, want_weights)

    def _render(self, model, cond, rays, generator, draws, want_weights):
        sb, n_rays = rays.shape[:2]
        cb = self._chunk_rays(n_rays, cond.num_views_per_obj,
                              latent_width=cond.latent_flat.shape[-1])
        pad = (-n_rays) % cb
        if pad:
            rays = torch.cat([rays, rays[:, :1].expand(sb, pad, 8)], dim=1)
        Bp = rays.shape[1]
        if draws is None:
            draws = self.draw(sb * Bp, generator, rays.device)
        draws = {k: _tensor(v, rays.device).reshape(sb, Bp, -1)
                 for k, v in draws.items()}

        chunks = []
        for start in range(0, Bp, cb):
            sl = slice(start, start + cb)
            d = {k: v[:, sl].reshape(sb * cb, -1) for k, v in draws.items()}
            chunks.append(self._render_chunk(
                model, cond, rays[:, sl].reshape(-1, 8), d, sb
            ))

        def joined(key):
            parts = [c[key].reshape(sb, cb, *c[key].shape[1:]) for c in chunks]
            return torch.cat(parts, dim=1).reshape(sb * Bp,
                                                   *parts[0].shape[2:])

        outputs = {"coarse": self._format(
            joined("w_c"), joined("rgb_c"), joined("depth_c"), sb,
            want_weights, n_rays)}
        if self.using_fine:
            outputs["fine"] = self._format(
                joined("w_f"), joined("rgb_f"), joined("depth_f"), sb,
                want_weights, n_rays)
        return outputs

    @staticmethod
    def _format(weights, rgb, depth, sb: int, want_weights: bool,
                n_rays: int) -> dict:
        ret = {
            "rgb": rgb.reshape(sb, -1, 3)[:, :n_rays],
            "depth": depth.reshape(sb, -1)[:, :n_rays],
        }
        if want_weights:
            ret["weights"] = weights.reshape(sb, -1, weights.shape[-1])[
                :, :n_rays
            ]
        return ret

    # -- sample schedule ---------------------------------------------------

    def sched_step(self, state: dict, steps: int = 1):
        """Advance the sampling schedule.

        :param state {"iter_idx": int, "last_sched": int}
        :return (new_renderer, new_state)
        """
        if self.sched is None:
            return self, state
        state = dict(state)
        state["iter_idx"] = state.get("iter_idx", 0) + steps
        renderer = self
        while (
            state.get("last_sched", 0) < len(self.sched[0])
            and state["iter_idx"] >= self.sched[0][state.get("last_sched", 0)]
        ):
            idx = state.get("last_sched", 0)
            renderer = dataclasses.replace(
                renderer,
                n_coarse=self.sched[1][idx],
                n_fine=self.sched[2][idx],
            )
            print(
                "INFO: NeRF sampling resolution changed on schedule ==> c",
                renderer.n_coarse,
                "f",
                renderer.n_fine,
            )
            state["last_sched"] = idx + 1
        return renderer, state
