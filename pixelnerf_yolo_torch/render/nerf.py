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

``__call__`` renders for inference, under ``torch.no_grad()``; ``render``
is the same render with autograd, the training render.  With ``train``
and ``noise_std > 0`` it adds Gaussian noise to sigma before compositing,
in each pass's composite order (the fine pass's sorted order).  The
importance samples follow the coarse weights as constants; the depth
samples keep the gradient of the coarse depth, which reaches the sample
points through the sort, the latent gather's coordinates and the field's
positional encoding.

``early_terminate = f`` (inference only, ignored under ``train``): the
fine pass runs on the top ⌈cb·f⌉ rays (rounded up to a multiple of 8) of
each chunk and scene by coarse weight sum, reusing their coarse latents;
the other rays keep their coarse rgb and depth as the fine output, and
their coarse weights, zero-padded to the union width, as its weights.
The sample draws are made over the whole chunk and then compacted, so a
kept ray's fine output is the ungated one, and f = 1 renders bitwise as
without the gate.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..ops.composite import composite
from ..ops.ray_sampling import sample_coarse, sample_fine, sample_fine_depth
from ..utils.profiling import scope


def _tensor(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, dtype=np.float32))
    return x.to(device=device, dtype=torch.float32)


def _pad_draws(d: torch.Tensor, n: int) -> torch.Tensor:
    """(SB, B, k) draws over a shard's B rays, padded to its n chunk-padded
    rays with each scene's first (the padding rays' outputs are dropped)."""
    pad = n - d.shape[1]
    if pad <= 0:
        return d
    return torch.cat([d, d[:, :1].expand(d.shape[0], pad, d.shape[2])], 1)


@dataclasses.dataclass(frozen=True)
class NeRFRenderer:
    n_coarse: int = 128
    n_fine: int = 0
    n_fine_depth: int = 0
    noise_std: float = 0.0
    depth_std: float = 0.01
    eval_batch_size: int = 100000
    white_bkgd: bool = False
    lindisp: bool = False
    sched: Optional[tuple] = None  # (iters, n_coarse list, n_fine list)
    early_terminate: float = 0.0
    device: str = "cuda"

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
            noise_std=conf.get_float("noise_std", 0.0),
            depth_std=conf.get_float("depth_std", 0.01),
            white_bkgd=bool(conf.get_float("white_bkgd", white_bkgd)),
            lindisp=lindisp,
            eval_batch_size=conf.get_int("eval_batch_size", eval_batch_size),
            sched=tuple(map(tuple, sched)) if sched is not None else None,
            early_terminate=conf.get_float("early_terminate", 0.0),
            device=device,
        )

    def _gated_capacity(self, cb: int) -> int:
        """Fine-pass rays of a cb-ray chunk under early_terminate: ⌈cb·f⌉
        rounded up to a multiple of 8, capped at cb."""
        c0 = max(1, math.ceil(cb * float(self.early_terminate)))
        return min(cb, ((c0 + 7) // 8) * 8)

    # -- internals -------------------------------------------------------

    def _chunk_rays(self, n_rays_per_scene: int, n_views: int = 1,
                    latent_width: int = 512,
                    grad_remat: bool = False) -> int:
        """Rays per chunk: a budget of ~2M field rows per chunk (rows =
        rays x the largest per-pass sample count x source views), scaled
        down for latents wider than 512; the conf's eval_batch_size only
        raises the budget.  Chunks are split evenly.

        grad_remat (training with model.remat): a 2^19-row budget, and
        eval_batch_size ignored, as in the JAX package: the checkpointed
        field's backward rebuilds a chunk's block activations at once."""
        k_max = self.n_coarse + (self.n_fine if self.using_fine else 0)
        rows_per_ray = max(k_max, 1) * max(n_views, 1)
        budget = (1 << (19 if grad_remat else 21)) * 512 // max(
            latent_width, 512)
        ebs = budget if grad_remat else max(self.eval_batch_size, budget)
        cap = max(1, ebs // rows_per_ray)
        if n_rays_per_scene <= cap:
            return n_rays_per_scene
        nc = -(-n_rays_per_scene // cap)
        return -(-n_rays_per_scene // nc)

    def draw(self, n_rows: int, generator: torch.Generator | None = None,
             device=None, train: bool = False) -> dict:
        """The render's random draws for ``n_rows`` (padded) rays; with
        train and noise_std > 0 also the standard normals of the coarse
        (noise_c) and the sorted fine (noise_f) sigma noise."""
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
        if train and self.noise_std > 0.0:
            d["noise_c"] = rand(self.n_coarse, torch.randn)
            if self.using_fine:
                d["noise_f"] = rand(self.n_coarse + self.n_fine, torch.randn)
        return d

    def batch_draws(self, sb: int, n_rays: int, cond, generator, device,
                    train: bool = False, grad_remat: bool = False) -> dict:
        """The draws a render of (sb, n_rays) rays makes: over its
        chunk-padded rays, scene-major.  A sharded render takes its slice
        of the global batch's."""
        cb = self._chunk_rays(n_rays, cond.num_views_per_obj,
                              latent_width=cond.latent_flat.shape[-1],
                              grad_remat=grad_remat)
        return self.draw(sb * (-(-n_rays // cb) * cb), generator, device,
                         train=train)

    def _eval_model(self, model, cond, rays, z_samp, coarse: bool, sb: int,
                    return_latent: bool = False):
        """Evaluate the field at all sample points of a chunk.

        rays (B, 8); z_samp (B, K).  Returns (B, K, d_out), and with
        return_latent also the (SB*NS, B*K/SB, C) latents for reuse (None
        where the model gathers inside its checkpoint, remat_gather).
        """
        B, K = z_samp.shape
        points = rays[:, None, :3] + z_samp[..., None] * rays[:, None, 3:6]
        pts = points.reshape(sb, -1, 3)
        vd = None
        if model.use_viewdirs:
            vd = rays[:, None, 3:6].expand(B, K, 3).reshape(sb, -1, 3)
        lat = (None if getattr(model, "remat_gather", False)
               else model.project_latent(cond, pts))
        out = model.forward(cond, pts, coarse=coarse, viewdirs=vd, latent=lat)
        out = out.reshape(B, K, -1)
        return (out, lat) if return_latent else out

    def _composite_pass(self, model, cond, rays, z_samp, coarse, sb,
                        return_latent: bool = False, sigma_noise=None):
        with scope("renderer_composite"):
            out = self._eval_model(model, cond, rays, z_samp, coarse, sb,
                                   return_latent=return_latent)
        latent = None
        if return_latent:
            out, latent = out
        comp = composite(out, z_samp, rays[:, -1:], white_bkgd=self.white_bkgd,
                         sigma_noise=sigma_noise)
        return (comp + (latent,)) if return_latent else comp

    def _fine_pass_reuse(self, model, cond, rays, z_union, k_coarse: int,
                         latent_c, sb, sigma_noise=None):
        """Fine pass evaluated in unsorted union order, so that the first
        k_coarse samples reuse the coarse pass's latents; the outputs are
        then put in sorted-z order (stable sort) before compositing.  The
        sort and the gather pass gradients to both z and the outputs.
        Without coarse latents (remat_gather) the field gathers them all."""
        B, Ku = z_union.shape
        Kn = Ku - k_coarse
        Bp = B // sb
        lat_u = None
        if latent_c is not None:
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
        with scope("renderer_composite"):
            out = model.forward(cond, pts_u.reshape(sb, -1, 3), coarse=False,
                                viewdirs=vd, latent=lat_u).reshape(B, Ku, -1)
        z_sorted, perm = torch.sort(z_union, dim=-1, stable=True)
        out_sorted = torch.gather(
            out.float(), 1, perm[..., None].expand(-1, -1, out.shape[-1])
        )
        return composite(out_sorted, z_sorted, rays[:, -1:],
                         white_bkgd=self.white_bkgd, sigma_noise=sigma_noise)

    def _render_chunk(self, model, cond, rays, draws: dict, sb: int,
                      train: bool):
        """Coarse + fine for one chunk of rays (sb * cb, 8)."""
        noise_c = noise_f = None
        if train and self.noise_std > 0.0:
            noise_c = draws["noise_c"] * self.noise_std
            if self.using_fine:
                noise_f = draws["noise_f"] * self.noise_std
        z_c = sample_coarse(rays, self.n_coarse, lindisp=self.lindisp,
                            u=draws["u_coarse"])
        w_c, rgb_c, depth_c, lat = self._composite_pass(
            model, cond, rays, z_c, True, sb, return_latent=True,
            sigma_noise=noise_c,
        )
        res = {"w_c": w_c, "rgb_c": rgb_c, "depth_c": depth_c}
        if not self.using_fine:
            return res
        if self.early_terminate > 0.0 and not train and lat is not None:
            res["w_f"], res["rgb_f"], res["depth_f"] = self._fine_gated(
                model, cond, rays, z_c, w_c, rgb_c, depth_c, lat, sb, draws)
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
            sb, sigma_noise=noise_f,
        )
        return res

    def _fine_gated(self, model, cond, rays, z_c, w_c, rgb_c, depth_c, lat,
                    sb: int, draws: dict):
        """The early-termination fine pass of one chunk (JAX
        ``_fine_gated``): the top-C rays of each scene by coarse weight sum
        (a stable descending sort: among equal sums the lower index first,
        as ``lax.top_k``) get the fine pass on their compacted draws and
        coarse latents; the fine outputs of the rest are their coarse ones.

        rays (sb*cb, 8); z_c, w_c (sb*cb, Kc); lat (sb*NS, cb*Kc, C)."""
        cb = rays.shape[0] // sb
        Kc = z_c.shape[1]
        NS = cond.num_views_per_obj
        Cc = self._gated_capacity(cb)
        wsum = w_c.sum(-1).reshape(sb, cb)
        idx = torch.sort(wsum, dim=1, descending=True,
                         stable=True).indices[:, :Cc]  # (sb, Cc)
        scene = torch.arange(sb, device=idx.device)[:, None]

        def take(x):
            xs = x.reshape(sb, cb, *x.shape[1:])[scene, idx]
            return xs.reshape(sb * Cc, *x.shape[1:])

        r2c = take(rays)
        samps = [take(z_c)]
        if "u" in draws:
            samps.append(sample_fine(
                r2c, take(w_c), self.n_fine - self.n_fine_depth, Kc,
                lindisp=self.lindisp, u=take(draws["u"]),
                u_jitter=take(draws["u_jitter"]),
            ))
        if "noise_d" in draws:
            samps.append(sample_fine_depth(
                r2c, take(depth_c), self.n_fine_depth,
                depth_std=self.depth_std, noise=take(draws["noise_d"]),
            ))
        C = lat.shape[-1]
        latc = lat.reshape(sb, NS, cb, Kc, C)[
            scene[:, :, None], torch.arange(NS, device=idx.device)[None, :,
                                                                   None],
            idx[:, None, :]].reshape(sb * NS, Cc * Kc, C)
        w_g, rgb_g, depth_g = self._fine_pass_reuse(
            model, cond, r2c, torch.cat(samps, dim=-1), Kc, latc, sb)

        def put(base, upd):
            b = base.reshape(sb, cb, *base.shape[1:]).clone()
            b[scene, idx] = upd.reshape(sb, Cc, *upd.shape[1:])
            return b.reshape(base.shape)

        w_base = torch.nn.functional.pad(w_c, (0, self.n_fine))
        return put(w_base, w_g), put(rgb_c, rgb_g), put(depth_c, depth_g)

    # -- public API --------------------------------------------------------

    @torch.no_grad()
    def __call__(self, model, cond, rays, generator=None, draws=None,
                 want_weights: bool = False) -> dict:
        """Render a ray batch, for inference (no autograd graph, no sigma
        noise).

        :param rays (SB, B, 8), moved to the renderer's device
        :param generator torch.Generator for the draws (default: torch's)
        :param draws optional pre-made draws, as ``draw`` returns them, over
          the padded batch (SB * B_padded rows, scene-major), or over the
          SB * B rays alone
        :return {"coarse": {"rgb" (SB,B,3), "depth" (SB,B), ["weights"]},
                 ["fine": {...}]}
        """
        return self.render(model, cond, rays, generator=generator,
                           draws=draws, want_weights=want_weights,
                           train=False)

    def render(self, model, cond, rays, generator=None, draws=None,
               want_weights: bool = False, train: bool = True) -> dict:
        """``__call__`` with autograd: the training render.  With train and
        noise_std > 0 the draws hold the sigma noise too (``draw(...,
        train=True)``)."""
        rays = _tensor(rays, self.device)
        if rays.ndim != 3:
            raise ValueError(f"rays must be (SB, B, 8), got {tuple(rays.shape)}")
        with scope("renderer_forward"):
            return self._render(model, cond, rays, generator, draws,
                                want_weights, train)

    def _render(self, model, cond, rays, generator, draws, want_weights,
                train):
        sb, n_rays = rays.shape[:2]
        cb = self._chunk_rays(
            n_rays, cond.num_views_per_obj,
            latent_width=cond.latent_flat.shape[-1],
            grad_remat=train and torch.is_grad_enabled()
            and getattr(model, "remat", False))
        pad = (-n_rays) % cb
        if pad:
            rays = torch.cat([rays, rays[:, :1].expand(sb, pad, 8)], dim=1)
        Bp = rays.shape[1]
        if draws is None:
            draws = self.draw(sb * Bp, generator, rays.device, train=train)
        draws = {k: _pad_draws(_tensor(v, rays.device).reshape(
            sb, -1, v.shape[-1]), Bp) for k, v in draws.items()}

        chunks = []
        for start in range(0, Bp, cb):
            sl = slice(start, start + cb)
            d = {k: v[:, sl].reshape(sb * cb, -1) for k, v in draws.items()}
            chunks.append(self._render_chunk(
                model, cond, rays[:, sl].reshape(-1, 8), d, sb, train
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

    def bind_parallel(self, *args, **kwargs):
        """``parallel.render.bind_parallel`` on this renderer."""
        from ..parallel.render import bind_parallel

        return bind_parallel(self, *args, **kwargs)

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
