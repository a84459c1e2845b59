"""``train_nerf``: the pixelNeRF trainer's ``train_step`` on objects held
on the host, the published SRN recipe.  A unit is one step on the next
``sb`` objects.  Set-up builds the one trainer that the window drives and
takes it through its first ``compared_steps`` steps, recording each
step's loss, the first gradient as Adam holds it and each parameter's
change; the check runs the reference (``reference/train_nerf.py``)
through the same steps: the trainer's view and pixel draws replayed from
the same generator seed, the render's draws passed to both.

``control=True`` puts the reference, in float8, in the program's place
(``calibrate.py``'s control)."""

from __future__ import annotations

import argparse
import copy
import os
import sys
import tempfile

import numpy as np
import torch

from .. import common
from ..reference.train_nerf import nerf_batch, nerf_step
from . import train
from .views import nerf_draws


class Driver(train.Driver):
    def __init__(self, cfg, traffic, seed, device, control: bool = False):
        cfg = copy.deepcopy(cfg)
        cfg["conf"].update(copy.deepcopy(traffic["conf"]))
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.control = control
        self.sc = cfg["scene"]
        self.r = cfg["conf"]["renderer"]
        self.tracing = False

    # -- inputs ------------------------------------------------------------

    def _objects(self):
        """The traffic's objects on the host: images (V, 3, S, S), poses
        (V, 4, 4) camera-to-world, focal, bbox (V, 4) of the object's
        pixels [cmin, rmin, cmax, rmax]."""
        sc, tr = self.sc, self.traffic
        out = []
        for o in range(tr["objects"]):
            rng = np.random.default_rng(common.sub_seed(self.seed, 13, o))
            gen = common.generator(self.device,
                                   common.sub_seed(self.seed, 14, o))
            images = common.object_images(gen, tr["views"],
                                          sc["image_size"], self.device)
            mask = (images < 1).any(1)
            rows, cols = mask.any(2), mask.any(1)
            first = lambda m: m.float().argmax(1)  # noqa: E731
            last = lambda m: m.shape[1] - 1 - first(m.flip(1))  # noqa: E731
            bbox = torch.stack([first(cols), first(rows), last(cols),
                                last(rows)], -1)
            out.append({
                "images": images.cpu().numpy(),
                "poses": common.sphere_views(tr["views"], sc["radius"], rng),
                "focal": np.float32(sc["focal"]),
                "bbox": bbox.float().cpu().numpy()})
        return out

    def _batch_objects(self, step: int):
        tr = self.traffic
        return [self.objects[(step * tr["sb"] + i) % tr["objects"]]
                for i in range(tr["sb"])]

    def _batch(self, step: int) -> dict:
        """The trainer's batch of the step's objects (a loader's
        collation)."""
        objs = self._batch_objects(step)
        return {k: np.stack([o[k] for o in objs])
                for k in ("images", "poses", "focal", "bbox")}

    def _draws(self, step: int, n_rays: int) -> dict:
        gen = common.generator(self.device,
                               common.sub_seed(self.seed, 15, step))
        return nerf_draws(gen, n_rays, self.r, self.device)

    def _rays_per_step(self) -> int:
        return self.traffic["sb"] * self.traffic["rays_per_object"]

    # -- the program ---------------------------------------------------------

    def setup(self):
        tr = self.traffic
        self.objects = self._objects()
        self.weights = common.benchmark_weights(self.cfg, self.seed,
                                                self.device)
        self.rng_seed = common.sub_seed(self.seed, 16)
        n = tr["compared_steps"]
        if self.control:
            self.losses, self.grads, self.deltas = self._reference(
                lowp="fp8")
            self.trainer = None
            return
        from pixelnerf_yolo_torch.config.hocon import Config
        from pixelnerf_yolo_torch.render import make_renderer
        from pixelnerf_yolo_torch.train import make_trainer

        # the trainer's event log falls back to its jsonl writer: where
        # TensorBoard is installed, its import loads TensorFlow and JAX
        sys.modules.setdefault("torch.utils.tensorboard", None)
        conf = Config(self.cfg["conf"])
        model = common.program_model(self.cfg, self.weights, self.device,
                                     conf)
        renderer = make_renderer(conf, device=self.device)
        self.workdir = tempfile.mkdtemp(prefix="bench_train_nerf_")
        args = argparse.Namespace(
            name="bench", resume=False,
            logs_path=os.path.join(self.workdir, "logs"),
            checkpoints_path=os.path.join(self.workdir, "ckpt"),
            visual_path=os.path.join(self.workdir, "vis"), epochs=1,
            lr=tr["lr"], gamma=1.0, batch_size=tr["sb"], nviews=str(tr["ns"]),
            freeze_enc=None, no_bbox_step=10 ** 9, fixed_test=None, seed=0,
            ray_batch_size=tr["rays_per_object"])

        class Objects:
            z_near, z_far, lindisp = self.sc["z_near"], self.sc["z_far"], \
                False

            def __len__(s):
                return len(self.objects)

            def __getitem__(s, i):
                raise IndexError("the benchmark feeds its batches")

        self.trainer = make_trainer(args, conf, Objects(), Objects(), model,
                                    renderer, [tr["ns"]], device=self.device)
        self.trainer._rng = np.random.default_rng(self.rng_seed)
        self.losses, self.grads = [], None
        for step in range(n):
            self.losses.append(float(self._step(step)["t"]))
            if step == 0:
                state = self.trainer.optimizer.state
                self.grads = {
                    name: state[p]["exp_avg"] / (1 - train.BETA1)
                    if "exp_avg" in state.get(p, {})
                    else torch.zeros_like(p)
                    for name, p in model.named_parameters()}
        self.deltas = {name: float(torch.linalg.vector_norm(
            p.detach() - self.weights[name]))
            for name, p in model.named_parameters()}

    def unit(self, i: int):
        if self.trainer is not None:  # the control has no program to step
            self._step(self.traffic["compared_steps"] + i)

    def _step(self, step: int):
        return self.trainer.train_step(
            self._batch(step), draws=self._draws(step, self._rays_per_step()))

    def per_unit(self) -> dict:
        """The reference algorithm's FLOPs of a step: three times the
        forward (the encoder on the source views, the coarse field on
        every (sample, view) row, the fine field on the coarse and fine
        samples)."""
        from ..flops import reference_flops

        S, tr, r = self.sc["image_size"], self.traffic, self.r
        rays, ns = self._rays_per_step(), tr["ns"]
        f = reference_flops(self.cfg["conf"], (tr["sb"] * ns, 3, S, S),
                            rays * r["n_coarse"] * ns, ns,
                            rays * (r["n_coarse"] + r["n_fine"]) * ns)
        return {"flops": 3 * (f["encoder"] + f["field"])}

    # -- the check -------------------------------------------------------------

    def _reference(self, lowp=None, steps=None):
        """The reference through the compared steps (or the first
        ``steps``): (losses, first gradients, parameter change norms)."""
        tr, sc = self.traffic, self.sc
        ref = common.reference_for(self.cfg, self.seed, self.device, lowp)
        ref.train()
        opt = torch.optim.Adam(ref.parameters(), lr=tr["lr"],
                               betas=(train.BETA1, 0.999), eps=1e-8)
        rng = np.random.default_rng(self.rng_seed)
        losses, grads = [], None
        for step in range(steps or tr["compared_steps"]):
            batch = nerf_batch(self._batch_objects(step), rng, tr["ns"],
                               tr["rays_per_object"], sc["z_near"],
                               sc["z_far"])
            loss, g = nerf_step(ref, opt, batch,
                                self._draws(step, self._rays_per_step()),
                                self.r, self.device)
            losses.append(loss)
            if step == 0:
                grads = g
        deltas = {name: float(torch.linalg.vector_norm(
            p.detach() - self.weights[name]))
            for name, p in ref.named_parameters()}
        del ref, opt
        return losses, grads, deltas
