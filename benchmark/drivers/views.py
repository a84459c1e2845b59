"""``views``: pixelNeRF's evaluation protocol.  Objects in turn; each
object's source view is encoded once, then each of its target views is
rendered whole (coarse and fine) and its image copied to the host.  A
unit is one view."""

from __future__ import annotations

import numpy as np
import torch

from .. import common
from ..reference.render import coarse_pass, fine_pass, sample_fine


def nerf_draws(gen, n: int, r: dict, device) -> dict:
    """The render's random numbers for n rays: stratified offsets, the
    importance samples' uniforms and jitters, the depth samples' normals."""
    n_imp = r["n_fine"] - r["n_fine_depth"]
    return {"u_coarse": torch.rand((n, r["n_coarse"]), generator=gen,
                                   device=device),
            "u": torch.rand((n, n_imp), generator=gen, device=device),
            "u_jitter": torch.rand((n, n_imp), generator=gen, device=device),
            "noise_d": torch.randn((n, r["n_fine_depth"]), generator=gen,
                                   device=device)}


class Driver:
    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.scene = cfg["scene"]
        self.r = cfg["conf"]["renderer"]
        self.V = traffic["views_per_object"]
        self.images = []  # the program's (coarse, fine) images, host
        self.kept = {}  # view -> the program's coarse (weights, depth)
        self.offset = common.sub_seed(seed, 5) % traffic["check_every"]
        self.tracing = False

    # -- inputs ----------------------------------------------------------

    def _object(self, obj: int):
        """(camera-to-world poses (V, 4, 4), the source image (1, 1, 3,
        S, S)) of object obj."""
        rng = np.random.default_rng(common.sub_seed(self.seed, 2, obj))
        poses = torch.as_tensor(common.sphere_views(
            self.V, self.scene["radius"], rng), device=self.device)
        gen = common.generator(self.device, common.sub_seed(self.seed, 3,
                                                            obj))
        img = common.object_images(gen, 1, self.scene["image_size"],
                                   self.device)
        return poses, img[None]

    def _view(self, poses, obj: int, v: int):
        sc = self.scene
        rays = common.rays_nerf(poses[v], sc["image_size"], sc["focal"],
                                sc["z_near"], sc["z_far"])
        gen = common.generator(self.device,
                               common.sub_seed(self.seed, 4, obj, v))
        return rays, nerf_draws(gen, rays.shape[0], self.r, self.device)

    # -- the program -------------------------------------------------------

    def setup(self):
        from pixelnerf_yolo_torch.config.hocon import Config
        from pixelnerf_yolo_torch.render import make_renderer

        conf = Config(self.cfg["conf"])
        weights = common.benchmark_weights(self.cfg, self.seed, self.device)
        self.model = common.program_model(self.cfg, weights, self.device,
                                          conf)
        del weights
        self.renderer = make_renderer(conf, device=self.device)
        self.obj, self.cond = None, None
        # the shapes of the window: one encode, whole views
        for v in range(self.traffic["warmup_views"]):
            self._render(0, v)
        self.obj = self.last = None

    def _render(self, obj: int, v: int):
        if obj != self.obj:
            self.poses, img = self._object(obj)
            src = self.traffic["source_view"]
            with torch.no_grad():
                self.cond = self.model.encode(img, self.poses[src][None, None],
                                              self.scene["focal"])
            self.obj = obj
        rays, draws = self._view(self.poses, obj, v)
        out = self.renderer(self.model, self.cond, rays[None], draws=draws,
                            want_weights=True)
        image = torch.stack([out[p]["rgb"][0] for p in ("coarse", "fine")]
                            ).cpu()
        return image, (out["coarse"]["weights"][0], out["coarse"]["depth"][0])

    def unit(self, i: int):
        image, coarse = self._render(*divmod(i, self.V))
        self.images.append(image)
        # the sample the check takes, every check_every-th view from an
        # offset drawn from the seed: their coarse weights and depth stay
        # on the device (no copy), to place the reference's fine samples
        # where the program put its own
        if (i + self.offset) % self.traffic["check_every"] == 0:
            self.kept[i] = coarse
        self.last = (i, coarse)

    def drain(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def end_to_end(self, win) -> dict:
        rays = win.units * self.scene["image_size"] ** 2
        return {"rays_per_s": rays / win.seconds}

    def per_unit(self) -> dict:
        """The reference algorithm's FLOPs of a view (one encode shared by
        the object's views)."""
        from ..flops import reference_flops

        S = self.scene["image_size"]
        r = self.r
        f = reference_flops(self.cfg["conf"], (1, 3, S, S), S * S
                            * r["n_coarse"], 1,
                            S * S * (r["n_coarse"] + r["n_fine"]))
        return {"flops": f["encoder"] / self.V + f["field"]}

    # -- the check -----------------------------------------------------------

    def numbers(self) -> dict:
        """The sampled views against the reference.  The coarse image is
        the reference's whole render; the fine image the reference's fine
        pass at the program's fine samples (placed by the reference from
        the program's coarse weights and depth with the same draws: the
        importance samples jump between bins with the smallest change of
        the weights, which would swamp the comparison).  For each, the
        share of pixels (``exc``) in which some channel is off by more than
        ``exc_k`` times the root mean square gap of the reference computed
        in bfloat16 (at a bfloat16 computation's rounding points: the
        rounding it cannot avoid) over the same views; ``image_exc`` that
        share over both images.  Read, not compared: ``fine_bins_moved``,
        the share of rays in which some importance sample falls in another
        bin when the reference places it from its own coarse weights."""
        kept = dict(self.kept)
        if self.last is not None:
            kept[self.last[0]] = self.last[1]
        kept = {i: tuple(t.float() for t in c) for i, c in kept.items()}
        self.model = self.cond = self.renderer = self.kept = None
        self.last = None
        common.release()
        refs = [common.reference_for(self.cfg, self.seed, self.device,
                                     lowp) for lowp in (None, "bf16")]
        block = self.traffic["check_block_rays"]
        gaps, moved = {"coarse": [], "fine": []}, []
        with torch.no_grad():
            for i, (w_c, depth_c) in sorted(kept.items()):
                obj, v = divmod(i, self.V)
                poses, img = self._object(obj)
                rays, draws = self._view(poses, obj, v)
                imgs = []
                for ref in refs:
                    cond = ref.encode(img, poses[self.traffic[
                        "source_view"]][None, None], self.scene["focal"])
                    parts = []
                    for s in range(0, rays.shape[0], block):
                        sl = slice(s, s + block)
                        d = {k: t[sl] for k, t in draws.items()}
                        w_r, rgb_r, _ = coarse_pass(ref, cond, rays[sl], d,
                                                    self.r)
                        parts.append((rgb_r, fine_pass(
                            ref, cond, rays[sl], d, self.r, w_c[sl],
                            depth_c[sl])[0]))
                        if ref is refs[0]:
                            moved.append(_bins_moved(rays[sl], w_r,
                                                     w_c[sl], d, self.r))
                    imgs.append([torch.cat([q[j] for q in parts])
                                 for j in range(2)])
                prog = self.images[i].to(self.device)
                for j, p in enumerate(("coarse", "fine")):
                    gaps[p].append((prog[j] - imgs[0][j],
                                    imgs[1][j] - imgs[0][j]))
        out = {"views": len(kept),
               "fine_bins_moved": float(torch.cat(moved).float().mean())}
        over_all = []
        for p, pairs in gaps.items():
            gap = torch.cat([g for g, _ in pairs])
            yard = torch.cat([y for _, y in pairs])
            rms = torch.sqrt((yard ** 2).mean(0))
            over = (gap.abs() > self.traffic["exc_k"] * rms).any(1)
            over_all.append(over)
            out[f"{p}_exc"] = common.finite(over.float().mean())
        out["image_exc"] = common.finite(torch.cat(over_all).float().mean())
        return out


def _bins_moved(rays, w_ref, w_prog, d, r) -> torch.Tensor:
    """(B,) whether some importance sample of a ray lies elsewhere when
    placed from the reference's coarse weights than from the program's."""
    k = r["n_coarse"]
    return (sample_fine(rays, w_ref, k, d["u"], d["u_jitter"])
            != sample_fine(rays, w_prog, k, d["u"], d["u_jitter"])).any(1)
