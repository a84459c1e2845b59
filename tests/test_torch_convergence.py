"""Convergence of the port's NeRF trainer: the port of
tests/test_convergence.py, the same recipes and bounds, driven through the
port's make_model / make_renderer / make_trainer on the CPU.

The two recipe tests are opt-in like the JAX package's: set PNY_RUN_SLOW=1
(knobs PNY_STEPS, PNY_RAYS, PNY_DTYPE as there).  Each recipe also runs
here at 3 steps, every time, so that it cannot rot while it is opt-in.
The recipes live in scripts/torch_convergence.py, which runs them on the
card on scenes held in memory; here they read tests/synth_data.py's files
through the port's SRN reader.

no_bbox_step = 0 matters: with bbox sampling only bbox-interior pixels are
supervised, and full-frame novel-view PSNR stays poor until it switches
off (tests/test_convergence.py's note).
"""

import importlib.util
import math
import os
from pathlib import Path

import numpy as np
import pytest

from synth_data import make_srn_dataset

SLOW = pytest.mark.skipif(
    not os.environ.get("PNY_RUN_SLOW"),
    reason="slow convergence test; set PNY_RUN_SLOW=1",
)
SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "torch_convergence.py"


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these runs are many small ops, which gain
    nothing from a thread pool and lose much to one when test workers
    share the cores."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def recipes():
    spec = importlib.util.spec_from_file_location("torch_convergence", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def overfit(tmp_path, steps, rays=512, image_size=128):
    """Single-scene overfit: novel-view PSNR of vis_step before and after
    ``steps`` steps of ``rays`` rays (f32, nviews 2, lr 5e-4), on views
    the SRN reader resizes to image_size (its default 128)."""
    from pixelnerf_yolo_torch.data import get_split_dataset

    root = str(tmp_path / "data" / "cars")
    for stage in ("train", "val", "test"):
        make_srn_dataset(root, stage=stage, n_objs=1, n_views=8, img_size=32)
    dset, val_dset, _ = get_split_dataset(
        "srn", root, image_size=(image_size, image_size))
    trainer, batch = recipes().overfit_trainer(
        dset, val_dset, str(tmp_path), "overfit", rays, "cpu")
    _, vals0 = trainer.vis_step(batch, 0, idx=0)
    for step in range(steps):
        losses = trainer.train_step(batch, step)
    _, vals = trainer.vis_step(batch, steps, idx=0)
    print(f"overfit PSNR {vals0['psnr']:.2f} -> {vals['psnr']:.2f} "
          f"loss {float(losses['t']):.4f} ({steps} steps)")
    return vals0["psnr"], vals["psnr"], float(losses["t"])


def multiscene(tmp_path, steps, rays, dtype, image_size=128):
    """The held-out recipe on 6 train scenes, 2 val scenes (seed 77), the
    views resized to image_size."""
    from pixelnerf_yolo_torch.data import get_split_dataset

    root = str(tmp_path / "data" / "cars")
    make_srn_dataset(root, stage="train", n_objs=6, n_views=8, img_size=32)
    make_srn_dataset(root, stage="val", n_objs=2, n_views=8, img_size=32,
                     seed=77)
    make_srn_dataset(root, stage="test", n_objs=1, n_views=8, img_size=32,
                     seed=88)
    dset, val_dset, _ = get_split_dataset(
        "srn", root, image_size=(image_size, image_size))
    res = recipes().nerf_multiscene(dset, val_dset, str(tmp_path), steps,
                                    rays, dtype, "cpu")
    print(f"multiscene val PSNR {res['psnr0']:.2f} -> {res['psnr']:.2f} "
          f"({steps} steps, {dtype})")
    return res


@SLOW
def test_nerf_overfit_novel_view_psnr(tmp_path):
    """PNY_STEPS (default 200) steps of 512 rays; JAX's bounds."""
    psnr0, psnr1, loss = overfit(tmp_path, int(os.environ.get("PNY_STEPS",
                                                              200)))
    assert loss < 0.04
    assert psnr1 > psnr0 + 5, (psnr0, psnr1)
    assert psnr1 > 17.0


def test_nerf_overfit_recipe_runs(tmp_path):
    """The overfit recipe at 3 steps, on the 32x32 views as written (no
    resize): the plumbing and finite numbers."""
    psnr0, psnr1, loss = overfit(tmp_path, 3, image_size=32)
    assert all(math.isfinite(x) for x in (psnr0, psnr1, loss))
    assert loss > 0


@SLOW
def test_nerf_multiscene_generalizes(tmp_path):
    """PNY_STEPS (default 80) steps of SB=2 x PNY_RAYS (default 256) rays in
    PNY_DTYPE (default bfloat16); JAX's bounds."""
    res = multiscene(tmp_path, int(os.environ.get("PNY_STEPS", 80)),
                     int(os.environ.get("PNY_RAYS", 256)),
                     os.environ.get("PNY_DTYPE", "bfloat16"))
    assert np.isfinite(res["loss"])
    assert res["psnr"] > res["psnr0"] + 4.0, res
    assert res["psnr"] > 14.0


def test_nerf_multiscene_recipe_runs(tmp_path):
    """The held-out recipe at 3 steps (bf16) on the 32x32 views as written:
    plumbing, finite numbers."""
    res = multiscene(tmp_path, 3, 256, "bfloat16", image_size=32)
    assert all(math.isfinite(res[k]) for k in ("psnr0", "psnr", "loss"))
    assert res["steps"] == 3 and res["route"]["refused"] == []
