"""Base training loop.

Counterpart of pixelnerf_yolo_tpu/train/trainer.py: interval-driven
print/eval/metric/save/backup/vis, the NaN-loss abort returning "nan"
(checked every ``nan_interval`` batches), best-F1 checkpointing, the
pause file, per-save .npy loss histories, epoch-wise exponential lr decay
with an optional linear warmup, gradient accumulation (accu_grad), resume
and the fixed_test option.  The loop records whatever loss keys the
trainer emits.

The optimizer is ``torch.optim.Adam(betas=(0.9, 0.999), eps=1e-8)``, which
is the JAX package's optax ``scale_by_adam`` followed by a step of -lr.
With ``accu_grad = k > 1`` the gradients of k train steps are averaged and
the optimizer steps once, as ``optax.MultiSteps`` does; a resume restarts
an accumulation window.

On a training mesh (``parallel.make_train_mesh``; ``bind_mesh``) every
rank takes rank 0's initial weights, the field MLP splits over 'model'
(``parallel.shard_model``), each rank's loss is its part of the global
loss (its local weighted sums over the global denominators) and the
gradients sum over the ray-sharding group (every rank with the same
'model' coordinate) before each Adam step, which runs on the rank's
parameters: whole, or its tensor-parallel shard with its shard of the
moments.  Only rank 0 prints, logs, writes visuals and writes
checkpoints, which hold the single-device layout (the shards gathered).
The loop's decisions (NaN abort, early restart) read reduced losses and
all-gathered renders, so every rank makes the same one.
"""

from __future__ import annotations

import math
import os
import os.path as osp
import time

import numpy as np
import torch

from .. import parallel
from ..data.loader import DataLoader
from ..parallel.collectives import all_reduce_, all_reduce_flat_
from ..utils.image import write_png
from ..utils.misc import print_with_time, stall_watchdog_from_env
from ..utils.profiling import scope
from . import checkpoints


class _JsonlWriter:
    """TensorBoard-free metric logger fallback (jsonl lines)."""

    def __init__(self, path):
        os.makedirs(path, exist_ok=True)
        self._f = open(osp.join(path, "metrics.jsonl"), "a")

    def add_scalar(self, tag, value, global_step=None):
        import json

        self._f.write(
            json.dumps({"tag": tag, "value": float(value), "step": global_step})
            + "\n"
        )
        self._f.flush()

    def add_scalars(self, tag, values, global_step=None):
        for k, v in values.items():
            self.add_scalar(f"{tag}/{k}", v, global_step)


class _NullWriter:
    """The writer of a rank that does not log."""

    def add_scalar(self, *args, **kwargs):
        pass

    def add_scalars(self, *args, **kwargs):
        pass


def make_writer(path):
    if not parallel.is_main():
        return _NullWriter()
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(path)
    except Exception:
        return _JsonlWriter(path)


class Trainer:
    """Subclasses implement train_step/eval_step/vis_step/metric_step and
    call ``init_opt_state`` with their parameters."""

    def __init__(self, train_dataset, test_dataset, args, conf):
        self.args = args
        self.train_dataset = train_dataset
        self.test_dataset = test_dataset

        # 8/4 prefetch threads: sample loading is disk IO + PNG decode,
        # which overlaps the train step.  Capped at the host core count:
        # more threads than cores just adds GIL thrash.
        cores = os.cpu_count() or 1
        self.train_data_loader = DataLoader(
            train_dataset,
            batch_size=args.batch_size,
            shuffle=True,
            seed=getattr(args, "seed", 0),
            num_workers=conf.get_int("num_workers", min(8, cores)),
        )
        self.test_data_loader = DataLoader(
            test_dataset,
            batch_size=min(args.batch_size, 16),
            shuffle=False,
            num_workers=conf.get_int("num_workers_test", min(4, cores)),
        )

        if parallel.world_size() > 1:
            # one global batch for every rank, loaded by rank 0
            self.train_data_loader = parallel.BroadcastLoader(
                self.train_data_loader)
            self.test_data_loader = parallel.BroadcastLoader(
                self.test_data_loader)

        self.num_total_batches = len(self.train_dataset)
        self.exp_name = args.name
        self.save_interval = conf.get_int("save_interval")
        self.backup_interval = conf.get_int("backup_interval")
        self.print_interval = conf.get_int("print_interval")
        # NaN-abort lag bound: each check forces a host sync; checking
        # every nan_interval batches bounds the abort lag at that many
        # steps while keeping the launch queue deep
        self.nan_interval = conf.get_int(
            "nan_interval", min(self.print_interval, 20)
        )
        self.vis_interval = conf.get_int("vis_interval")
        self.eval_interval = conf.get_int("eval_interval")
        self.metric_interval = conf.get_int("metric_interval")
        self.num_epoch_repeats = conf.get_int("num_epoch_repeats", 1)
        self.num_epochs = args.epochs
        self.accu_grad = conf.get_int("accu_grad", 1)
        self.summary_path = osp.join(args.logs_path, args.name)
        os.makedirs(self.summary_path, exist_ok=True)
        self.writer = make_writer(self.summary_path)

        self.fixed_test = bool(getattr(args, "fixed_test", False))

        # Adam + per-epoch exponential decay: lr(epoch) = lr0 * gamma^epoch,
        # with a linear warmup over the first train.warmup_steps global
        # steps (0 = off)
        self.base_lr = args.lr
        self.gamma = args.gamma
        self.warmup_steps = conf.get_int("warmup_steps", 0)
        self._lr = float(args.lr)
        self.optimizer = None
        self._accum = 0  # train steps accumulated into the gradients
        # (assembled inputs, draws) of the latest train update, which
        # ``update_cost_analysis`` runs again
        self._last_update = None

        self.iter_state_path = osp.join(
            args.checkpoints_path, args.name, "_iter"
        )
        self.optim_state_path = osp.join(
            args.checkpoints_path, args.name, "_optim"
        )
        self.lrsched_state_path = osp.join(
            args.checkpoints_path, args.name, "_lrsched"
        )
        self.start_iter_id = 0
        self.start_epoch = 0

        self.visual_path = osp.join(args.visual_path, args.name)
        self.conf = conf
        # the training mesh (``bind_mesh``) and its ray-sharding group
        self.mesh = None
        self.dp_group = None

    # -- the mesh ------------------------------------------------------------

    def bind_mesh(self, mesh) -> None:
        """Train over mesh (None: one device): rank 0's weights on every
        rank, the field MLP split over 'model'.  Call before
        ``init_opt_state``."""
        self.mesh = mesh
        if mesh is None:
            return
        parallel.broadcast_module(self.model)
        parallel.shard_model(self.model, mesh)
        self.dp_group = parallel.mesh_group(mesh, parallel.ray_axes(mesh))

    def _shards(self, n_scenes: int):
        """How this rank takes its part of a global batch of n_scenes:
        (scene slice, ray shards, its ray shard, BatchNorm group).  Scenes
        shard over 'data' when it divides n_scenes, rays over 'rays', and
        BatchNorm syncs over 'data'; otherwise (the ragged variant) every
        rank takes every scene, rays shard over 'data' x 'rays' and each
        rank's BatchNorm statistics are already global."""
        m = self.mesh
        data_n = parallel.axis_size(m, parallel.DATA_AXIS)
        if n_scenes % data_n:
            return (slice(None), parallel.n_shards(m),
                    parallel.shard_index(m), None)
        d = parallel.axis_index(m, parallel.DATA_AXIS)
        per = n_scenes // data_n
        return (slice(d * per, (d + 1) * per),
                parallel.axis_size(m, parallel.RAY_AXIS),
                parallel.axis_index(m, parallel.RAY_AXIS),
                m.get_group(parallel.DATA_AXIS) if data_n > 1 else None)

    def _ray_multiple(self, n_scenes: int) -> int:
        """The multiple a ray (or chunk) axis pads to on the mesh."""
        return self._shards(n_scenes)[1] if self.mesh is not None else 1

    def reduce_losses(self, loss_dict: dict) -> dict:
        """Each rank's parts of the losses summed over the ray-sharding
        group: the global losses, the same on every rank."""
        if self.dp_group is None:
            return loss_dict
        keys = list(loss_dict)
        v = all_reduce_(torch.stack([loss_dict[k] for k in keys]),
                        self.dp_group)
        return dict(zip(keys, v.unbind()))

    # -- state owned by subclasses -----------------------------------------

    def init_opt_state(self, params):
        self.optimizer = torch.optim.Adam(list(params), lr=self._lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        if self.args.resume:
            if os.path.exists(self.optim_state_path):
                try:
                    self.optimizer.load_state_dict(
                        parallel.shard_optimizer_state(
                            checkpoints.load_state(self.optim_state_path),
                            self.model))
                except Exception:
                    import warnings

                    warnings.warn(
                        "Failed to load optimizer state at "
                        + self.optim_state_path
                    )
            if os.path.exists(self.iter_state_path):
                state = checkpoints.load_json(self.iter_state_path)
                self.start_iter_id = state["iter"]
                self.start_epoch = state.get("epoch", 0)
            if os.path.exists(self.lrsched_state_path):
                sched = checkpoints.load_json(self.lrsched_state_path)
                self.start_epoch = sched.get("epoch", self.start_epoch)

    def backward_and_step(self, total: torch.Tensor) -> None:
        """Backpropagate one train step's loss; every accu_grad steps,
        average the accumulated gradients and take an Adam step at the
        current lr.  The gradients stay in ``.grad`` until the next
        accumulation window starts."""
        if self._accum == 0:
            self.optimizer.zero_grad(set_to_none=True)
        total.backward()
        self._accum += 1
        if self._accum < self.accu_grad:
            return
        self._accum = 0
        with scope("optimizer"):
            if self.dp_group is not None:
                # the parameters are f32: one flat all-reduce
                all_reduce_flat_([p.grad for g in self.optimizer.param_groups
                                  for p in g["params"] if p.grad is not None],
                                 self.dp_group)
            for group in self.optimizer.param_groups:
                group["lr"] = self._lr
                if self.accu_grad > 1:
                    for p in group["params"]:
                        if p.grad is not None:
                            p.grad.div_(self.accu_grad)
            self.optimizer.step()

    def update_cost_analysis(self):
        """The executed FLOPs of one train update (JAX
        ``update_cost_analysis``): ``{"flops": F}`` for the latest train
        step's update (encoder and render forward, the loss, the backward
        with the kernel route's plain recompute, Adam), or None before the
        first train step.

        F is counted by ``utils.profiling.count_flops`` over one more
        update of that step's assembled inputs and draws, after which the
        weights and buffers, the gradients, the Adam state, the generators
        and the renderer's schedule are put back as they were.  Its
        formulas are ``torch.utils.flop_counter``'s: products and
        convolutions (the kernel ops their twins' products), so Adam and
        every other elementwise op count 0.  There is no "bytes accessed":
        ``FlopCounterMode`` counts no bytes.  On a mesh every rank calls
        it (the update's collectives run), and F is this rank's part."""
        if self._last_update is None:
            return None
        import copy

        from ..utils.profiling import count_flops

        inputs, draws = self._last_update
        weights = {k: v.clone() for k, v in self.model.state_dict().items()}
        grads = [(p, p.grad) for p in self.model.parameters()]
        opt = copy.deepcopy(self.optimizer.state_dict())
        gen = self._gen.get_state() if hasattr(self, "_gen") else None
        kept = (self._accum, self.accu_grad,
                copy.deepcopy(getattr(self, "renderer_sched_state", None)))
        self._accum, self.accu_grad = 0, 1

        def update():
            total, _ = self.compute_losses(*inputs, train=True, **draws)
            self.backward_and_step(total)

        try:
            counts = count_flops(update)[1]
        finally:
            self.model.load_state_dict(weights)
            for p, g in grads:
                p.grad = g
            self.optimizer.load_state_dict(opt)
            if gen is not None:
                self._gen.set_state(gen)
            self._accum, self.accu_grad, sched = kept
            if sched is not None:
                self.renderer_sched_state = sched
        return {"flops": float(sum(counts.values()))}

    def current_lr(self, epoch: int) -> float:
        return self.base_lr * (self.gamma**epoch)

    def lr_at(self, epoch: int, step_id: int) -> float:
        """Epoch-decayed lr scaled by the linear warmup ramp when the
        global step is still inside ``train.warmup_steps``."""
        lr = self.current_lr(epoch)
        if self.warmup_steps > 0 and step_id < self.warmup_steps:
            lr *= (step_id + 1) / self.warmup_steps
        return lr

    def set_lr(self, lr: float):
        """The lr of the next optimizer step."""
        self._lr = float(lr)

    # -- subclass hooks ------------------------------------------------------

    def post_batch(self, epoch, batch):
        pass

    def extra_save_state(self):
        pass

    def save_model_state(self, epochNum: str = ""):
        """The weights in the single-device layout (every rank gathers its
        shards; rank 0 writes)."""
        state = parallel.full_state_dict(self.model)
        if parallel.is_main():
            checkpoints.save_weights(self.args, self.model,
                                     epochNum=epochNum, state=state)

    def train_step(self, data, global_step):
        raise NotImplementedError()

    def eval_step(self, data, global_step):
        raise NotImplementedError()

    def vis_step(self, data, global_step):
        return None, None

    def metric_step(self, data_loader, print_hc=False):
        return None, None, None

    # -- the loop --------------------------------------------------------------

    def start(self):
        def fmt_loss_str(losses):
            if not isinstance(losses, dict):
                return "loss " + str(losses)
            return "loss " + " ".join(
                k + ":" + str(losses[k]) for k in losses
            )

        def data_loop(dl):
            while True:
                for x in iter(dl):
                    yield x

        test_data_iter = data_loop(self.test_data_loader)
        step_id = self.start_iter_id

        # opt-in lost-device abort (utils.misc.StallWatchdog): with
        # PNY_STALL_ABORT_S set, hard-exit instead of hanging
        watchdog = stall_watchdog_from_env()
        try:
            return self._run_epochs(
                test_data_iter, step_id, fmt_loss_str, watchdog
            )
        finally:
            if watchdog is not None:
                watchdog.stop()

    def _run_epochs(self, test_data_iter, step_id, fmt_loss_str, watchdog):
        print_with_time("Starting training with", self.num_epochs, "epochs")

        save: dict[str, list] = {}
        best_f1 = 0.0

        for epoch in range(self.start_epoch, self.num_epochs):
            lr = self.current_lr(epoch)
            self.set_lr(lr)
            self.writer.add_scalar("lr", lr, global_step=step_id)

            batch = 0
            for _ in range(self.num_epoch_repeats):
                for data in self.train_data_loader:
                    # pause file: wait while ./pause exists
                    if os.path.exists("pause"):
                        print_with_time("pause file found, pausing")
                        while os.path.exists("pause"):
                            time.sleep(5)
                        print_with_time("pause file removed, resuming")

                    # warmup ramp; at step_id == warmup_steps this restores
                    # the full epoch lr and the per-epoch set_lr takes over
                    if self.warmup_steps > 0 and step_id <= self.warmup_steps:
                        self.set_lr(self.lr_at(epoch, step_id))

                    # train_step returns device scalars; reading them (float)
                    # waits for the step, so only the print and NaN
                    # intervals do: off-interval steps queue back to back
                    losses = self.train_step(data, global_step=step_id)
                    if watchdog is not None:
                        watchdog.beat()
                    if batch % self.nan_interval == 0 and losses:
                        t_val = float(losses["t"])
                        if watchdog is not None:
                            watchdog.beat()
                        if math.isnan(t_val):
                            print_with_time(
                                "NaN detected in trainer after train_step "
                                "at epoch", epoch, "batch", batch,
                            )
                            return "nan"
                    if batch % self.print_interval == 0:
                        losses = {k: float(v) for k, v in losses.items()}
                        loss_str = fmt_loss_str(losses)
                        print_with_time(
                            "E", epoch, "B", batch, loss_str, " lr", self._lr
                        )
                        for k, v in losses.items():
                            save.setdefault(k + "_array", []).append(v)

                    if batch % self.eval_interval == 0:
                        test_data = next(test_data_iter)
                        test_losses = {
                            k: float(v)
                            for k, v in self.eval_step(
                                test_data, global_step=step_id
                            ).items()
                        }
                        if watchdog is not None:
                            watchdog.beat()
                        print_with_time(
                            "*** Eval:", "E", epoch, "B", batch,
                            fmt_loss_str(test_losses), " lr",
                        )
                        for k, v in test_losses.items():
                            save.setdefault("eval_" + k + "_array", []).append(v)

                    if batch % self.metric_interval == 0 and (
                        epoch > 0 or batch > 200
                    ):
                        precision, recall, f1 = self.metric_step(
                            self.test_data_loader
                        )
                        if watchdog is not None:
                            # a metric sweep renders the whole test set
                            # (can exceed the stall window while healthy)
                            watchdog.beat()
                        if f1 is not None:
                            print_with_time(
                                "*** Metrics:", "E", epoch, "B", batch,
                                "precision", precision, "recall", recall,
                                "f1", f1,
                            )
                            save.setdefault("precision_array", []).append(
                                precision
                            )
                            save.setdefault("recall_array", []).append(recall)
                            save.setdefault("f1_array", []).append(f1)
                            if f1 > best_f1:
                                best_f1 = f1
                                print_with_time("saving best")
                                self.save_model_state(epochNum="_best")

                    if batch % self.backup_interval == 0 and (
                        epoch > 0 or batch > 0
                    ):
                        print_with_time("saving backup")
                        self.save_model_state(epochNum=str(epoch - 1))

                    if batch % self.save_interval == 0 and (
                        epoch > 0 or batch > 0
                    ):
                        print_with_time("saving")
                        self.save_model_state()
                        if watchdog is not None:
                            watchdog.beat()
                        optim_state = parallel.full_optimizer_state(
                            self.optimizer, self.model)
                    if batch % self.save_interval == 0 and (
                        epoch > 0 or batch > 0
                    ) and parallel.is_main():
                        checkpoints.save_state(
                            self.optim_state_path, optim_state)
                        checkpoints.save_json(
                            self.lrsched_state_path, {"epoch": epoch}
                        )
                        checkpoints.save_json(
                            self.iter_state_path,
                            {"iter": step_id + 1, "epoch": epoch},
                        )
                        self.extra_save_state()
                        for key, arr in save.items():
                            np.save(
                                osp.join(self.args.logs_path, key + ".npy"),
                                np.array(arr),
                            )

                    if batch % self.vis_interval == 0:
                        print_with_time("generating visualization")
                        if self.fixed_test:
                            test_data = next(iter(self.test_data_loader))
                        else:
                            test_data = next(test_data_iter)
                        vis, vis_vals = self.vis_step(
                            test_data, global_step=step_id
                        )
                        if watchdog is not None:
                            watchdog.beat()
                        if vis is None and vis_vals is None:
                            return "no_vis"
                        if vis_vals is not None:
                            self.writer.add_scalars(
                                "vis", vis_vals, global_step=step_id
                            )
                        if vis is not None and parallel.is_main():
                            vis_u8 = (np.clip(vis, 0, 1) * 255).astype(
                                np.uint8
                            )
                            os.makedirs(self.visual_path, exist_ok=True)
                            write_png(
                                osp.join(
                                    self.visual_path,
                                    "{:04}_{:04}_vis.png".format(epoch, batch),
                                ),
                                vis_u8,
                            )

                    self.post_batch(epoch, batch)
                    step_id += 1
                    batch += 1
        # wait for the last queued step before returning
        try:
            if isinstance(losses, dict):
                float(losses["t"])
        except (NameError, UnboundLocalError):
            pass
        return "done"
