"""The port's training CLI in NeRF mode (``python -m
pixelnerf_yolo_torch.train -F srn``) on the CPU: two steps on a synthetic
SRN directory from a temporary directory, with a small conf written
there; the checkpoints and the renderer's schedule state it writes, a
resume that restores them, and the device the CLI defaults to."""

import json
import os

import numpy as np
import pytest
import torch

from synth_data import make_srn_dataset

from pixelnerf_yolo_torch.train import __main__ as cli
from pixelnerf_yolo_torch.train import checkpoints

# bench.py's train_nerf schema at test size, saving after every step; the
# sample counts change on the schedule after the first step
NERF_CLI_CONF = """
model {
    use_encoder = True
    use_xyz = True
    use_code = True
    code { num_freqs = 6
           freq_factor = 1.5
           include_input = True }
    use_viewdirs = True
    use_code_viewdirs = False
    mlp_coarse { type = resnet
                 n_blocks = 5
                 d_hidden = 64
                 combine_layer = 3
                 combine_type = average }
    mlp_fine { type = resnet
               n_blocks = 5
               d_hidden = 64
               combine_layer = 3
               combine_type = average }
    encoder { backbone = resnet18
              pretrained = False
              num_layers = 2
              index_padding = zeros }
}
renderer { type = nerf
           n_coarse = 8
           n_fine = 4
           n_fine_depth = 2
           noise_std = 0.5
           sched = [[1], [16], [8]]
           white_bkgd = True }
loss { lambda_coarse = 1.0
       lambda_fine = 1.0
       rgb { use_l1 = False }
       rgb_fine { use_l1 = False } }
train { print_interval = 1
        save_interval = 1
        backup_interval = 10000
        vis_interval = 10000
        eval_interval = 10000
        metric_interval = 10000
        accu_grad = 1
        num_epoch_repeats = 1 }
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The CLI trained for one epoch (2 scenes, -B 1: 2 steps) from a
    fresh directory; returns (directory, argv, checkpoint dir)."""
    tmp = tmp_path_factory.mktemp("nerf_cli")
    root = str(tmp / "data" / "cars")
    for stage in ("train", "val", "test"):
        make_srn_dataset(root, stage=stage, n_objs=2, n_views=4, img_size=32)
    conf = tmp / "srn_small.conf"
    conf.write_text(NERF_CLI_CONF)
    argv = ["-c", str(conf), "-D", root, "-F", "srn", "-n", "cli", "-B", "1",
            "-V", "1", "-R", "32", "--epochs", "1", "--device", "cpu"]
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
    from pixelnerf_yolo_torch.train import PixelNeRFTrainer, make_trainer

    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        args, conf = parse_args(cli.extra_args, training=True,
                                argv=argv + (["--resume"] if resume else []))
        dset, val, _ = get_split_dataset("srn", args.datadir)
        model = make_model(conf.get_config("model"), device="cpu")
        tr = make_trainer(args, conf, dset, val, model,
                          make_renderer(conf, device="cpu"), [1],
                          device="cpu")
        assert isinstance(tr, PixelNeRFTrainer)
        return tr
    finally:
        os.chdir(cwd)


def test_cli_writes_checkpoints_and_schedule(run):
    tmp, _, ckpt = run
    for name in ("pixel_nerf_latest", "_optim", "_lrsched", "_iter",
                 "_renderer"):
        assert (ckpt / name).exists(), name
    assert json.loads((ckpt / "_iter").read_text()) == {"iter": 2, "epoch": 0}
    # the schedule moved after the first batch, before the second's save
    assert json.loads((ckpt / "_renderer").read_text()) == {
        "iter_idx": 1, "last_sched": 1}
    for key in ("rc", "rf", "t"):
        hist = np.load(tmp / "logs" / f"{key}_array.npy")
        assert hist.shape == (2,) and np.isfinite(hist).all()
    # the vis and eval intervals ran at batch 0: a panel image was written
    assert list((tmp / "visuals" / "cli").glob("*_vis.png"))


def test_resume_restores_weights_and_schedule(run):
    tmp, argv, ckpt = run
    fresh = _trainer(tmp, argv, resume=False)
    tr = _trainer(tmp, argv, resume=True)
    assert tr.renderer_sched_state == {"iter_idx": 1, "last_sched": 1}
    assert fresh.renderer_sched_state == {"iter_idx": 0, "last_sched": 0}
    # as in the JAX package (and the reference, whose renderer saves the
    # same two counters): a schedule step the saved state has passed is
    # not taken again, so the resumed renderer keeps the conf's counts
    # until the next step of the schedule
    assert (tr.renderer.n_coarse, tr.renderer.n_fine) == (8, 4)
    assert (tr.start_iter_id, tr.start_epoch) == (2, 0)
    saved = checkpoints.load_state(str(ckpt / "pixel_nerf_latest"))
    state = tr.model.state_dict()
    assert set(saved) == set(state)
    assert all(torch.equal(state[k], t) for k, t in saved.items())
    assert any(not torch.equal(fresh.model.state_dict()[k], t)
               for k, t in saved.items())
    assert tr.optimizer.state_dict()["state"]


def test_cli_resume_continues(run):
    tmp, argv, ckpt = run
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        i = argv.index("--epochs")
        assert cli.main(argv[:i + 1] + ["2"] + argv[i + 2:]
                        + ["--resume"]) == "done"
    finally:
        os.chdir(cwd)
    assert json.loads((ckpt / "_iter").read_text()) == {"iter": 6, "epoch": 1}
    # 1 restored + 3 batches before the last save (the last batch's
    # schedule step comes after it)
    assert json.loads((ckpt / "_renderer").read_text())["iter_idx"] == 4


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
