"""The port's training CLI (``python -m pixelnerf_yolo_torch.train``) and
trainer loop on the CPU: two steps written to checkpoints in the JAX
package's layout, a resume that restores the weights, the iteration, the
epoch and the Adam state, the loss falling on one batch, gradient
accumulation, the lr warmup, the NaN abort, the vis and metric steps,
and the devices the entry points default to."""

import json
import math
import os

import numpy as np
import pytest
import torch

from synth_data import make_yolo_dataset

from pixelnerf_yolo_torch.train import __main__ as cli
from pixelnerf_yolo_torch.train import checkpoints

# the repo's dry-run YOLO trainer conf (resnet18 with 2 layers, d_hidden
# 64, 16 coarse samples, 16-ray chunks), saving after every step
SAVE_EVERY_STEP = """
train { save_interval = 1
        print_interval = 1 }
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The CLI trained for one epoch (2 scenes, -B 1: 2 steps) from a
    fresh directory; returns (directory, argv, checkpoint dir)."""
    from __graft_entry__ import _DRYRUN_YOLO_CONF

    tmp = tmp_path_factory.mktemp("cli")
    root = make_yolo_dataset(str(tmp / "data"), n_scenes=2, n_views=4,
                             img_size=64)
    conf = tmp / "yolo_dryrun.conf"
    conf.write_text(_DRYRUN_YOLO_CONF + SAVE_EVERY_STEP)
    argv = ["-c", str(conf), "-D", root, "-F", "yolo", "-n", "cli",
            "-B", "1", "-V", "3", "--epochs", "1", "--device", "cpu"]
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        assert cli.main(argv) == "done"
    finally:
        os.chdir(cwd)
    return tmp, argv, tmp / "checkpoints" / "cli"


def _trainer(tmp, argv, resume):
    """The trainer the CLI builds for argv, without training."""
    from pixelnerf_yolo_torch.config.args import parse_args
    from pixelnerf_yolo_torch.data import get_split_dataset
    from pixelnerf_yolo_torch.models import make_model
    from pixelnerf_yolo_torch.render import make_renderer
    from pixelnerf_yolo_torch.train import make_trainer

    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        args, conf = parse_args(cli.extra_args, training=True,
                                argv=argv + (["--resume"] if resume else []))
        dset, val, _ = get_split_dataset("yolo", args.datadir, conf=conf)
        model = make_model(conf.get_config("model"), device="cpu")
        return make_trainer(args, conf, dset, val, model,
                            make_renderer(conf, device="cpu"), [3],
                            device="cpu")
    finally:
        os.chdir(cwd)


def test_cli_writes_checkpoints(run):
    tmp, _, ckpt = run
    for name in ("pixel_nerf_latest", "_optim", "_lrsched", "_iter",
                 "_renderer"):
        assert (ckpt / name).exists(), name
    assert json.loads((ckpt / "_iter").read_text()) == {"iter": 2, "epoch": 0}
    assert json.loads((ckpt / "_lrsched").read_text()) == {"epoch": 0}
    assert not list(ckpt.glob("*.tmp"))
    # per-save loss histories of the 5 reported losses
    hist = np.load(tmp / "logs" / "t_array.npy")
    assert hist.shape == (2,) and np.isfinite(hist).all()


def test_resume_restores_weights_iteration_and_adam(run):
    tmp, argv, ckpt = run
    fresh = _trainer(tmp, argv, resume=False)
    tr = _trainer(tmp, argv, resume=True)
    assert (tr.start_iter_id, tr.start_epoch) == (2, 0)
    assert (fresh.start_iter_id, fresh.start_epoch) == (0, 0)
    saved = checkpoints.load_state(str(ckpt / "pixel_nerf_latest"))
    state = tr.model.state_dict()
    assert set(saved) == set(state)
    moved = 0
    for k, t in saved.items():
        assert torch.equal(state[k], t), k
        moved += not torch.equal(fresh.model.state_dict()[k], t)
    assert moved > 0  # the steps changed the weights
    opt = tr.optimizer.state_dict()
    ref = checkpoints.load_state(str(ckpt / "_optim"))
    assert opt["param_groups"] == ref["param_groups"]
    assert set(opt["state"]) == set(ref["state"]) and opt["state"]
    for i, s in ref["state"].items():
        assert float(s["step"]) == 2
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt["state"][i][key], s[key])
    assert not fresh.optimizer.state_dict()["state"]


def test_cli_resume_continues(run):
    """--resume with a second epoch: training goes on from the saved
    iteration and epoch.  The save names the epoch it was made in, so
    the resumed run takes epoch 0 again, then epoch 1 (2 + 2 + 2 steps),
    as the JAX package's trainer does."""
    tmp, argv, ckpt = run
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        i = argv.index("--epochs")
        assert cli.main(argv[:i + 1] + ["2"] + argv[i + 2:]
                        + ["--resume", "-n", "cli"]) == "done"
    finally:
        os.chdir(cwd)
    assert json.loads((ckpt / "_iter").read_text()) == {"iter": 6, "epoch": 1}
    assert (ckpt / "pixel_nerf_backup").exists()


def test_cli_defaults_to_the_card(run, monkeypatch):
    """Without --device the CLI trains on cuda: on a machine without a
    card it fails instead of moving to the CPU."""
    tmp, argv, _ = run
    from pixelnerf_yolo_torch.config.args import parse_args

    monkeypatch.chdir(tmp)
    i = argv.index("--device")
    base = argv[:i] + argv[i + 2:] + ["-n", "nocard"]
    args, _ = parse_args(cli.extra_args, training=True, argv=base)
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            cli.main(base)


def test_cli_multi_gpu_raises(run, monkeypatch):
    tmp, argv, _ = run
    monkeypatch.chdir(tmp)
    with pytest.raises(NotImplementedError, match="item 20"):
        cli.main(argv + ["--gpu_id", "0 1", "-n", "multi"])


@pytest.fixture(scope="module")
def trainer_setup(tmp_path_factory):
    """(a maker of fresh CPU trainers on the dry-run conf, a train batch,
    a val loader)."""
    from pixelnerf_yolo_torch.config.hocon import parse_string
    from pixelnerf_yolo_torch.data import DataLoader, get_split_dataset
    from pixelnerf_yolo_torch.models import make_model
    from pixelnerf_yolo_torch.render import make_renderer
    from pixelnerf_yolo_torch.train import make_trainer
    from torch_parity import train_args, yolo_train_conf

    tmp = tmp_path_factory.mktemp("steps")
    root = make_yolo_dataset(str(tmp / "data"), n_scenes=2, n_views=4,
                             img_size=64)
    conf = yolo_train_conf(parse_string, "auto")
    dset, val, _ = get_split_dataset("yolo", root, conf=conf)

    def make(**extra):
        model = make_model(conf.get_config("model"), device="cpu")
        return make_trainer(train_args(tmp, "steps", **extra), conf, dset,
                            val, model, make_renderer(conf, device="cpu"),
                            [3], device="cpu")

    batch = next(iter(DataLoader(dset, batch_size=1)))
    return make, batch, DataLoader(val, batch_size=1)


def test_train_steps_decrease_loss(trainer_setup):
    make, batch, _ = trainer_setup
    tr = make()
    losses0 = tr.train_step(batch)
    assert set(losses0) == {"t", "box_loss", "object_loss",
                            "no_object_loss", "class_loss"}
    assert math.isfinite(float(losses0["t"]))
    for _ in range(4):
        losses = tr.train_step(batch)
    assert math.isfinite(float(losses["t"]))
    assert float(losses["t"]) < float(losses0["t"])


def test_accu_grad_averages_then_steps(trainer_setup):
    """accu_grad = 2: the first step leaves the parameters, the second
    takes one Adam step on the mean of the two gradients; with the same
    views and draws twice that is one plain step."""
    make, batch, _ = trainer_setup
    one, two = make(), make()
    two.accu_grad = 2
    u = torch.rand((16, 16), generator=torch.Generator().manual_seed(0))
    before = {k: p.detach().clone() for k, p in two.model.named_parameters()}
    one.train_step(batch, u=u)
    two.train_step(batch, u=u)
    for k, p in two.model.named_parameters():
        assert torch.equal(p, before[k]), k
    two._rng = np.random.default_rng(1)  # the first step's views again
    two.train_step(batch, u=u)
    moved = 0
    for (k, p), q in zip(two.model.named_parameters(),
                         one.model.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=1e-6, msg=k)
        moved += not torch.equal(p, before[k])
    assert moved > 0


def test_lr_schedule(trainer_setup):
    make, _, _ = trainer_setup
    tr = make(lr=1e-3, gamma=0.5)
    assert tr.lr_at(0, 0) == 1e-3 and tr.lr_at(2, 0) == 2.5e-4
    tr.warmup_steps = 4
    assert [tr.lr_at(1, s) for s in (0, 3, 4)] == [1.25e-4, 5e-4, 5e-4]


def test_nan_loss_aborts(trainer_setup, monkeypatch):
    make, _, _ = trainer_setup
    tr = make()
    monkeypatch.setattr(tr, "train_step",
                        lambda data, global_step=None: {"t": float("nan")})
    assert tr.start() == "nan"


def test_vis_and_metric_steps(trainer_setup):
    make, batch, val_loader = trainer_setup
    tr = make()
    gt, pred = tr.vis_step(batch, idx=0, srcs=np.array([0, 2, 3]), dest=0,
                           only_bbox=True)
    assert isinstance(gt, list) and isinstance(pred, list)
    assert len(gt) > 0 and len(pred) > 0 and len(gt[0]) == 6
    vis, _ = tr.vis_step(batch, idx=0, srcs=np.array([0, 2, 3]), dest=0)
    assert vis is not None and vis.ndim == 3
    p, r, f1 = tr.metric_step(val_loader)
    assert 0 <= p <= 1 and 0 <= r <= 1 and 0 <= f1 <= 1
    tr.use_host_nms = True
    assert tr.metric_step(val_loader) == (p, r, f1)


def test_make_trainer_raises_for_nerf(trainer_setup):
    from pixelnerf_yolo_torch.config.hocon import parse_string
    from pixelnerf_yolo_torch.train import make_trainer

    conf = parse_string("renderer { type = nerf }")
    with pytest.raises(NotImplementedError, match="item 16"):
        make_trainer(None, conf, None, None, None, None, [1], device="cpu")


def test_count_parameters_matches_jax():
    """utils.misc.count_parameters on the port's state_dict's parameters
    and on the module equals the JAX package's count of its params."""
    from pixelnerf_yolo_tpu.models import make_model as jmake_model
    from pixelnerf_yolo_tpu.utils.misc import count_parameters as jcount
    from pixelnerf_yolo_torch.utils.misc import count_parameters
    from torch_parity import perturbed_variables, port_model, small_yolo
    from torch_parity import yolo_scene

    conf = small_yolo()
    v = perturbed_variables(jmake_model(conf.get_config("model")),
                            yolo_scene(ns=1)[0][0])
    tm = port_model(conf, v)
    params = dict(tm.named_parameters())
    assert count_parameters(tm) == count_parameters(params) \
        == jcount(v["params"]) > 0


def test_stall_watchdog(monkeypatch):
    """The watchdog copy fires after a stall, not while beaten, and is
    started only when PNY_STALL_ABORT_S is set."""
    import time

    from pixelnerf_yolo_torch.utils.misc import (StallWatchdog,
                                                 stall_watchdog_from_env)

    fired = []
    wd = StallWatchdog(0.2, poll_s=0.05, _exit=fired.append).start()
    try:
        deadline = time.monotonic() + 5.0
        while not fired and time.monotonic() < deadline:
            time.sleep(0.05)
        assert fired == [3]
    finally:
        wd.stop()
    fired.clear()
    wd = StallWatchdog(0.5, poll_s=0.05, _exit=fired.append).start()
    try:
        for _ in range(8):
            time.sleep(0.1)
            wd.beat()
        assert not fired
    finally:
        wd.stop()
    monkeypatch.delenv("PNY_STALL_ABORT_S", raising=False)
    assert stall_watchdog_from_env() is None
    monkeypatch.setenv("PNY_STALL_ABORT_S", "600")
    wd = stall_watchdog_from_env()
    try:
        assert isinstance(wd, StallWatchdog) and wd.timeout_s == 600
    finally:
        wd.stop()
