"""``train``: the YOLO trainer's ``train_step`` on scenes held on the
host.  A unit is one step on the next scene.  Set-up builds the one
trainer that the window drives and takes it through its first
``compared_steps`` steps, recording each step's loss, the first
gradient as Adam holds it and each parameter's change; the check runs
the reference through the same steps.

``control=True`` puts the reference, in float8, in the program's place
(``calibrate.py``'s control)."""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

from .. import common
from ..reference.train import yolo_batch, yolo_step

BETA1 = 0.9  # Adam's first moment, as the trainer builds it


def wh_iou(wh, anchors):
    inter = np.minimum(wh[0], anchors[:, 0]) * np.minimum(wh[1],
                                                           anchors[:, 1])
    return inter / (wh[0] * wh[1] + anchors[:, 0] * anchors[:, 1] - inter)


def grid_targets(boxes, grid: int, anchors, ignore: float):
    """(grid, grid, A, 6) [prob, x, y, w, h, class] of [x, y, w, h, class]
    boxes (fractions of the view): each box on its best free anchor of its
    cell, in cell units; other anchors above ``ignore`` wh-IoU flagged -1
    (the reference implementation's assignment at one scale)."""
    A = len(anchors)
    t = np.zeros((grid, grid, A, 6), np.float32)
    for x, y, w, h, cls in boxes:
        ious = wh_iou(np.array([w, h]), anchors)
        i, j = int(grid * y), int(grid * x)
        placed = False
        for a in np.argsort(-ious, kind="stable"):
            taken = t[i, j, a, 0]
            if not taken and not placed:
                t[i, j, a] = [1, grid * x - j, grid * y - i, w * grid,
                              h * grid, cls]
                placed = True
            elif not taken and ious[a] > ignore:
                t[i, j, a, 0] = -1
    return t


class Driver:
    def __init__(self, cfg, traffic, seed, device, control: bool = False):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.control = control
        self.y = cfg["conf"]["yolo"]
        self.sc = cfg["scene"]
        self.tracing = False

    # -- inputs ------------------------------------------------------------

    def _scenes(self):
        """The traffic's scenes on the host: images (V, 3, S, S), poses
        (V, 4, 4) world-to-camera, focal, c, grid targets (V, g, g, A, 6)."""
        tr, sc, y = self.traffic, self.sc, self.y
        S, cell = sc["image_size"], y["cell_sizes"][0]
        anchors = np.asarray(y["anchors"][0], np.float32)
        out = []
        for s in range(tr["scenes"]):
            rng = np.random.default_rng(common.sub_seed(self.seed, 7, s))
            gen = common.generator(self.device,
                                   common.sub_seed(self.seed, 8, s))
            images = common.object_images(gen, tr["views"], S, self.device)
            targets = []
            for _ in range(tr["views"]):
                n = rng.integers(tr["boxes"][0], tr["boxes"][1] + 1)
                wh = rng.uniform(*tr["box_size"], (n, 2))
                xy = rng.uniform(0.05, 0.95, (n, 2))
                cls = rng.integers(0, 2, n)
                cls[0], cls[-1] = 0, 1  # both classes in every view
                boxes = [[*xy[k], *wh[k], cls[k]] for k in range(n)]
                targets.append(grid_targets(boxes, S // cell, anchors,
                                            y["ignore_iou_thresh"]))
            out.append({
                "images": images.cpu().numpy(),
                "poses": common.ring_extrinsics(
                    tr["views"], sc["radius"], sc["height"], rng),
                "focal": np.full(2, sc["focal"], np.float32),
                "c": np.full(2, S / 2, np.float32),
                "targets": np.stack(targets)})
        return out

    def _draws(self, step: int, n_rays: int) -> torch.Tensor:
        gen = common.generator(self.device,
                               common.sub_seed(self.seed, 9, step))
        return torch.rand((n_rays, self.cfg["conf"]["renderer"]["n_coarse"]),
                          generator=gen, device=self.device)

    def _rays_per_step(self) -> int:
        """Every cell of the source views, padded to whole chunks."""
        g = self.sc["image_size"] // self.y["cell_sizes"][0]
        R = self.y["ray_batch_size"]
        return -(-self.traffic["ns"] * g * g // R) * R

    @staticmethod
    def _batch(scene) -> dict:
        """The trainer's batch of one scene (a loader's collation)."""
        return {"images": scene["images"][None], "poses": scene["poses"][None],
                "focal": scene["focal"][None], "c": scene["c"][None],
                "bboxes": [(t[None],) for t in scene["targets"]]}

    # -- the program ---------------------------------------------------------

    def setup(self):
        self.scenes = self._scenes()
        self.weights = common.benchmark_weights(self.cfg, self.seed,
                                                self.device)
        self.rng_seed = common.sub_seed(self.seed, 10)
        n = self.traffic["compared_steps"]
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
        self.workdir = tempfile.mkdtemp(prefix="bench_train_")
        args = argparse.Namespace(
            name="bench", resume=False,
            logs_path=os.path.join(self.workdir, "logs"),
            checkpoints_path=os.path.join(self.workdir, "ckpt"),
            visual_path=os.path.join(self.workdir, "vis"), epochs=1,
            lr=self.traffic["lr"], gamma=1.0, batch_size=1,
            nviews=str(self.traffic["ns"]), freeze_enc=None,
            no_bbox_step=10 ** 9, fixed_test=None, seed=0,
            ray_batch_size=self.y["ray_batch_size"])

        class Scenes:
            z_near, z_far, lindisp = self.sc["z_near"], self.sc["z_far"], \
                False

            def __len__(s):
                return len(self.scenes)

            def __getitem__(s, i):
                raise IndexError("the benchmark feeds its batches")

        self.trainer = make_trainer(args, conf, Scenes(), Scenes(), model,
                                    renderer, [self.traffic["ns"]],
                                    device=self.device)
        self.trainer._rng = np.random.default_rng(self.rng_seed)
        self.batches = [self._batch(s) for s in self.scenes]
        self.losses, self.grads = [], None
        for step in range(n):
            self.losses.append(float(self._step(step)["t"]))
            if step == 0:
                # the gradient as Adam got it: its first moment after one
                # step, (1 - beta1) g (none where it took no step)
                state = self.trainer.optimizer.state
                self.grads = {
                    name: state[p]["exp_avg"] / (1 - BETA1)
                    if "exp_avg" in state.get(p, {})
                    else torch.zeros_like(p)
                    for name, p in model.named_parameters()}
        self.deltas = {name: float(torch.linalg.vector_norm(
            p.detach() - self.weights[name]))
            for name, p in model.named_parameters()}

    def _step(self, step: int):
        batch = self.batches[step % len(self.batches)]
        return self.trainer.train_step(
            batch, u=self._draws(step, self._rays_per_step()))

    def unit(self, i: int):
        self._step(self.traffic["compared_steps"] + i)

    def drain(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def end_to_end(self, win) -> dict:
        return {"train_steps_per_s": win.units / win.seconds}

    def per_unit(self) -> dict:
        """The reference algorithm's FLOPs of a step: three times the
        forward (the encoder on the source views, the field on every
        (sample, view) row)."""
        from ..flops import reference_flops

        S, ns = self.sc["image_size"], self.traffic["ns"]
        rows = self._rays_per_step() * self.cfg["conf"]["renderer"][
            "n_coarse"] * ns
        f = reference_flops(self.cfg["conf"], (ns, 3, S, S), rows, ns)
        return {"flops": 3 * (f["encoder"] + f["field"])}

    # -- the check -------------------------------------------------------------

    def _reference(self, lowp=None, steps=None):
        """The reference through the compared steps (or the first
        ``steps``): (losses, first gradients, parameter change norms)."""
        ref = common.reference_for(self.cfg, self.seed, self.device, lowp)
        ref.train()
        opt = torch.optim.Adam(ref.parameters(), lr=self.traffic["lr"],
                               betas=(BETA1, 0.999), eps=1e-8)
        rng = np.random.default_rng(self.rng_seed)
        y, sc = self.y, self.sc
        losses, grads = [], None
        for step in range(steps or self.traffic["compared_steps"]):
            scene = self.scenes[step % len(self.scenes)]
            sel, rays, tgt = yolo_batch(
                scene, rng, self.traffic["ns"], y["cell_sizes"][0],
                y["ray_batch_size"], sc["z_near"], sc["z_far"])
            loss, g = yolo_step(ref, opt, scene, sel, rays, tgt,
                                self._draws(step, rays.shape[0]),
                                self.cfg["conf"], self.device)
            losses.append(loss)
            if step == 0:
                grads = g
        deltas = {name: float(torch.linalg.vector_norm(
            p.detach() - self.weights[name]))
            for name, p in ref.named_parameters()}
        del ref, opt
        return losses, grads, deltas

    def numbers(self) -> dict:
        """Against the reference through the same steps: each step's loss
        (relative gap; ``loss1_gap`` the first's: the later steps' losses
        follow Adam's steps, whose signs flip with rounding).  By leaf,
        against the reference's norm of that leaf or of the median leaf,
        whichever is larger: the gap of the first gradient's norm (the
        worst leaf) and of the change's norm (the worst and the median
        leaf); ``grad_exc``, the share of leaves whose first gradient
        differs from the reference's by more than ``exc_k`` times the
        difference of the reference computed in bfloat16 (the rounding a
        bfloat16 computation cannot avoid: rounding moves a norm only in
        the second order, the difference in the first).  Leaves whose
        reference gradient is under a thousandth of the median leaf's are
        left out, and counted."""
        if self.trainer is not None:
            self.trainer = None
            shutil.rmtree(self.workdir, ignore_errors=True)
        common.release()
        losses, grads, deltas = self._reference()
        # the yardstick: the first step of the reference computed in
        # bfloat16 (values and gradients at bf16 rounding points)
        yard = self._reference("bf16", steps=1)[1]
        over = {k: float(torch.linalg.vector_norm(self.grads[k] - v))
                > self.traffic["exc_k"] * float(
                    torch.linalg.vector_norm(yard[k] - v))
                for k, v in grads.items()}
        del yard
        norm = {k: float(torch.linalg.vector_norm(v))
                for k, v in grads.items()}
        prog = {k: float(torch.linalg.vector_norm(v))
                for k, v in self.grads.items()}
        self.grads = None
        # the median over the leaves the reference's gradient reaches (in
        # YOLO mode a step whose source views see none of each other's
        # samples gives the encoder no gradient at all)
        med_g = float(np.median([v for v in norm.values() if v > 0]))
        keep = [k for k, v in norm.items() if v >= 1e-3 * med_g]
        med_d = float(np.median([deltas[k] for k in keep]))
        g = {k: common.rel_gap(prog[k], norm[k], med_g) for k in keep}
        d = {k: common.rel_gap(self.deltas[k], deltas[k], med_d)
             for k in keep}
        worst = max(g, key=g.get)
        print(f"train check: worst gradient leaf {worst} ({g[worst]!r}), "
              f"worst change leaf {max(d, key=d.get)}", file=sys.stderr)
        return {
            "loss1_gap": common.rel_gap(self.losses[0], losses[0], 1e-12),
            "loss_gap": max(common.rel_gap(a, b, 1e-12)
                            for a, b in zip(self.losses, losses)),
            "grad_exc": float(np.mean([over[k] for k in keep])),
            "grad_gap": g[worst],
            "delta_gap_median": float(np.median(list(d.values()))),
            "delta_gap": max(d.values()),
            "leaves_left_out": len(norm) - len(keep)}
