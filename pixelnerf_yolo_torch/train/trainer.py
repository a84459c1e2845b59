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
"""

from __future__ import annotations

import math
import os
import os.path as osp
import time

import numpy as np
import torch

from ..data.loader import DataLoader
from ..utils.image import write_png
from ..utils.misc import print_with_time, stall_watchdog_from_env
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


def make_writer(path):
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
        # when a list, train steps append (stage, CUDA event) at the end of
        # each stage (``_mark``): the stage split of a step on the card
        self.stage_events = None

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

    # -- state owned by subclasses -----------------------------------------

    def init_opt_state(self, params):
        self.optimizer = torch.optim.Adam(list(params), lr=self._lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        if self.args.resume:
            if os.path.exists(self.optim_state_path):
                try:
                    self.optimizer.load_state_dict(
                        checkpoints.load_state(self.optim_state_path))
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
        self._mark("backward")
        self._accum += 1
        if self._accum < self.accu_grad:
            return
        self._accum = 0
        for group in self.optimizer.param_groups:
            group["lr"] = self._lr
            if self.accu_grad > 1:
                for p in group["params"]:
                    if p.grad is not None:
                        p.grad.div_(self.accu_grad)
        self.optimizer.step()

    def _mark(self, stage: str) -> None:
        if self.stage_events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.stage_events.append((stage, ev))

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
        raise NotImplementedError()

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
                        checkpoints.save_state(
                            self.optim_state_path,
                            self.optimizer.state_dict()
                        )
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
                        if vis is not None:
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
