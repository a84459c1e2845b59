"""The port's training CLI on 2 CPU ranks (``--gpu_id "0 1" --device
cpu``), with and without ``--model_parallel 2``, and the multi-rank dry run
(``python -m pixelnerf_yolo_torch.parallel.dryrun --n 4 --device cpu``):
an epoch of the repo's dry-run YOLO conf runs to its end, rank 0 alone
prints and writes one checkpoint, and that checkpoint (and its Adam state)
holds the single-device layout: it loads strictly into a 1-rank model."""

import os
import subprocess
import sys

import pytest
import torch

from synth_data import make_yolo_dataset

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TIMEOUT = 240  # seconds a multi-rank run may take
SAVE_EVERY_STEP = """
train { save_interval = 1
        print_interval = 1 }
"""


def _run(argv, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, "-m", *argv], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from __graft_entry__ import _DRYRUN_YOLO_CONF

    tmp = tmp_path_factory.mktemp("par_cli")
    root = make_yolo_dataset(str(tmp / "data"), n_scenes=2, n_views=4,
                             img_size=64)
    conf = tmp / "yolo_dryrun.conf"
    conf.write_text(_DRYRUN_YOLO_CONF + SAVE_EVERY_STEP)
    return tmp, ["-c", str(conf), "-D", root, "-F", "yolo", "-B", "1",
                 "-V", "3", "--epochs", "1", "--device", "cpu",
                 "--gpu_id", "0 1"]


def _one_rank_model():
    from __graft_entry__ import _DRYRUN_YOLO_CONF
    from pixelnerf_yolo_torch.config.hocon import parse_string
    from pixelnerf_yolo_torch.models import make_model

    conf = parse_string(_DRYRUN_YOLO_CONF)
    return make_model(conf.get_config("model"), device="cpu",
                      load_pretrained=False)


@pytest.mark.parametrize("mp", [1, 2])
def test_train_cli_two_ranks(setup, mp):
    """2 steps on 2 ranks (mesh data 1 x rays 2, or data 1 x rays 1 x
    model 2): one checkpoint in the 1-rank layout, each loss line once."""
    from pixelnerf_yolo_torch.train import checkpoints

    tmp, argv = setup
    name = f"two_{mp}"
    out = _run(["pixelnerf_yolo_torch.train", *argv, "-n", name,
                "--model_parallel", str(mp)], tmp)
    assert "process group: 2 ranks over gloo" in out
    want = {"data": 1, "rays": 2} if mp == 1 else {"data": 1, "rays": 1,
                                                   "model": 2}
    assert f"training mesh {want}" in out
    assert out.count("] E 0 B 0 loss") == 1
    assert out.count("] E 0 B 1 loss") == 1
    ckpt = tmp / "checkpoints" / name
    model = _one_rank_model()
    state = checkpoints.load_state(str(ckpt / "pixel_nerf_latest"))
    model.load_state_dict(state, strict=True)
    assert state["mlp_coarse.blocks.0.fc_0.weight"].shape == (64, 64)
    assert all(torch.isfinite(t.float()).all() for t in state.values())
    # the Adam state in the single-device layout: it loads into an Adam
    # over the 1-rank model's parameters
    opt = torch.optim.Adam(model.parameters())
    opt.load_state_dict(checkpoints.load_state(str(ckpt / "_optim")))
    params = list(model.parameters())
    for i, s in opt.state_dict()["state"].items():
        assert s["exp_avg"].shape == params[i].shape


def test_dryrun_four_ranks(setup):
    """The full (data 2, rays 1, model 2) mesh at 4 ranks, then the
    1-vs-4 render leg."""
    tmp, _ = setup
    out = _run(["pixelnerf_yolo_torch.parallel.dryrun", "--n", "4",
                "--device", "cpu"], tmp)
    assert ("dryrun OK: YOLOTrainer mesh={'data': 2, 'rays': 1, 'model': 2}"
            " ranks=4") in out
    assert "dryrun OK: RenderParallel 1-vs-4 ranks allclose" in out


def test_dryrun_dataset_is_the_test_writers(tmp_path):
    """parallel/_synth.py's copy of make_yolo_dataset writes the files
    tests/synth_data.py writes for the same arguments: poses, intrinsics,
    boxes and split lists byte for byte, the images pixel for pixel."""
    import imageio.v2 as imageio
    import numpy as np

    from pixelnerf_yolo_torch.parallel import _synth

    a = make_yolo_dataset(str(tmp_path / "tests"), n_scenes=2, n_views=3,
                          img_size=32, seed=4)
    b = _synth.make_yolo_dataset(str(tmp_path / "port"), n_scenes=2,
                                 n_views=3, img_size=32, seed=4)
    files = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), b)
                           for d, _, fs in os.walk(b) for f in fs)
    assert len(files) == 3 + 2 * (1 + 3 * 3)
    for f in files:
        pa, pb = os.path.join(a, f), os.path.join(b, f)
        if f.endswith(".png"):
            np.testing.assert_array_equal(imageio.imread(pb),
                                          imageio.imread(pa))
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), f
