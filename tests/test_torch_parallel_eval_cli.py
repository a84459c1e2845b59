"""The port's evaluation CLIs on 2 CPU ranks (``--gpu_id "0 1" --device
cpu``: one spawned process a rank over gloo, each render's rays sharded
over them, rank 0 printing and writing) against the same CLI on one rank
(``--gpu_id 0``), on the datasets and weights of
tests/test_torch_eval_cli.py: the same printed metrics within that file's
tolerances (PSNR 1e-4 dB, SSIM 1e-6, F1 and the YOLO table exactly, mAP
1e-6) and the same files.  Every process runs torch on one thread: there
the ranks' renders equal the one rank's bitwise, where at 8 threads the
CPU's matrix products round a 128-row shard and a 256-row batch apart
(2e-7) and random-weight boxes near the NMS threshold flip.  Each render's
ray count is even, so that the ranks pad no ray: a padded ray takes draws
from the generator (as in JAX, the draws cover the padded batch), and
every later render's draws move.  The NeRF renders take one source view:
the test conf's field (2 blocks, combine_layer 3) never averages the
views, and its rows then mix across rays, in both packages, so that its
NS=2 render depends on the batch it is in.  calc_metrics renders nothing
and takes the list as it is."""

import os
import subprocess
import sys

import numpy as np
import pytest

from synth_data import make_yolo_dataset
from test_torch_eval_cli import (MAP_TOL, NAME, PSNR_TOL, SSIM_TOL,
                                 YOLO_2SCALE_CONF, _files, _final,
                                 _nerf_argv, _port_cli, _read_kv, _run,
                                 _table, _write_weights, _yolo_argv,
                                 nerf_setup)
from torch_parity import one_torch_thread

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TIMEOUT = 180  # seconds a 2-rank CLI run may take
# the fixtures this file uses
__all__ = ["nerf_setup", "one_torch_thread"]


@pytest.fixture(scope="module")
def yolo_setup(tmp_path_factory):
    """tests/test_torch_eval_cli.py's YOLO set at 128 px: 2 x 2 and 4 x 4
    cells a view at its two scales, even ray counts."""
    tmp = str(tmp_path_factory.mktemp("par_eval_cli_yolo"))
    root = make_yolo_dataset(os.path.join(tmp, "data"), n_scenes=2,
                             n_views=4, img_size=128, randomize=True, seed=3)
    _, tdir = _write_weights(tmp, YOLO_2SCALE_CONF,
                             np.zeros((3, 3, 32, 32), np.float32))
    return root, None, tdir


def _two_ranks(name, argv, cwd, stdin=None):
    """The CLI on 2 CPU ranks in a subprocess: its standard output."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "pixelnerf_yolo_torch.eval." + name, *argv,
         "--device", "cpu", "--gpu_id", "0 1"],
        cwd=cwd, env=env, input=stdin, capture_output=True, text=True,
        timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "process group: 2 ranks over gloo" in proc.stdout
    return proc.stdout


def _one_rank(monkeypatch, capsys, name, argv, cwd):
    return _run(monkeypatch, capsys, cwd, lambda: _port_cli(name).main(
        argv + ["--device", "cpu", "--gpu_id", "0"]))


def _same_pngs(d1, d2):
    import imageio.v2 as imageio

    assert _files(d1) == _files(d2) and _files(d1)
    for f in _files(d1):
        if f.endswith((".png", ".gif")):
            a = np.asarray(imageio.imread(os.path.join(d1, f))).astype(int)
            b = np.asarray(imageio.imread(os.path.join(d2, f))).astype(int)
            assert np.abs(a - b).max() <= 1, f


def _moved(cwd, src, dst):
    os.replace(os.path.join(cwd, src), os.path.join(cwd, dst))
    return os.path.join(cwd, dst)


def test_eval_two_ranks(nerf_setup, monkeypatch, capsys):
    root, _, tdir = nerf_setup
    argv = _nerf_argv(root, ["--split", "test", "-P", "0", "-O", "par1"])
    one = _final(_one_rank(monkeypatch, capsys, "eval", argv, tdir))
    argv[argv.index("par1")] = "par2"
    two = _final(_two_ranks("eval", argv, tdir))
    assert abs(two[0] - one[0]) <= PSNR_TOL
    assert abs(two[1] - one[1]) <= SSIM_TOL
    _same_pngs(os.path.join(tdir, "par1"), os.path.join(tdir, "par2"))


def test_eval_approx_two_ranks(nerf_setup, monkeypatch, capsys):
    root, _, tdir = nerf_setup
    argv = _nerf_argv(root, ["--split", "val", "-P", "0",
                             "--batch_size", "2"])
    one = _final(_one_rank(monkeypatch, capsys, "eval_approx", argv, tdir))
    two = _final(_two_ranks("eval_approx", argv, tdir))
    assert abs(two[0] - one[0]) <= PSNR_TOL
    assert abs(two[1] - one[1]) <= SSIM_TOL


def test_gen_video_two_ranks(nerf_setup, monkeypatch, capsys):
    root, _, tdir = nerf_setup
    argv = _nerf_argv(root, ["--split", "test", "-P", "0", "--num_views",
                             "4", "--radius", "1.3"])
    vis = os.path.join("visuals", NAME)
    _one_rank(monkeypatch, capsys, "gen_video", argv, tdir)
    one = _moved(tdir, vis, "video1")
    out = _two_ranks("gen_video", argv, tdir)
    assert out.count("Wrote to") == 1  # rank 0 alone writes
    _same_pngs(one, os.path.join(tdir, vis))


def test_eval_real_two_ranks(nerf_setup, monkeypatch, capsys):
    _, _, tdir = nerf_setup
    sample = os.path.join(REPO, "input", "toyota_normalize.png")
    argv = ["-n", NAME, "-c", "run.conf", "--input", sample, "--output",
            "real1", "--size", "16", "--out_size", "12", "--num_views", "3",
            "--gif", "--ray_batch_size", "96"]
    _one_rank(monkeypatch, capsys, "eval_real", argv, tdir)
    argv[argv.index("real1")] = "real2"
    _two_ranks("eval_real", argv, tdir)
    _same_pngs(os.path.join(tdir, "real1"), os.path.join(tdir, "real2"))


def test_eval_yolo_two_ranks(yolo_setup, monkeypatch, capsys):
    root, _, tdir = yolo_setup
    argv = _yolo_argv(root)
    header = "Precision\tRecall\tF1\tmAP@0.5"
    one = _table(_one_rank(monkeypatch, capsys, "eval_yolo", argv, tdir),
                 header)
    two = _table(_two_ranks("eval_yolo", argv, tdir), header)
    assert len(one) == len(two) == 3
    ov, tv = one[0].split("\t"), two[0].split("\t")
    assert tv[:3] == ov[:3]  # precision, recall, F1 exactly
    assert abs(float(tv[3]) - float(ov[3])) <= MAP_TOL
    assert two[1:] == one[1:]


def test_gen_images_yolo_two_ranks(yolo_setup, monkeypatch, capsys):
    """Rank 0 reads the thresholds from the launcher's stdin and hands
    them to rank 1; both render, rank 0 writes the panels."""
    import builtins

    root, _, tdir = yolo_setup
    argv = _yolo_argv(root, ["-P", "0 2 3", "--dest", "2"])
    answers = ["0.45", "0.75", "0.6", "0.5", "q"]
    it = iter(answers)
    monkeypatch.setattr(builtins, "input", lambda *a: next(it))
    vis = os.path.join("visuals", "yolo_vis")
    _one_rank(monkeypatch, capsys, "gen_images_yolo", argv, tdir)
    one = _moved(tdir, vis, "panels1")
    _two_ranks("gen_images_yolo", argv, tdir, stdin="\n".join(answers) + "\n")
    assert len(_files(one)) == 2
    _same_pngs(one, os.path.join(tdir, vis))


def test_calc_metrics_takes_a_list(nerf_setup, monkeypatch, capsys):
    root, _, tdir = nerf_setup
    argv = _nerf_argv(root, ["--split", "test", "-O", "cm", "-P", "0"])
    _one_rank(monkeypatch, capsys, "eval", argv, tdir)
    out = os.path.join(tdir, "cm")
    cm = ["-D", root, "-O", out, "-F", "dvr", "--overwrite", "--device",
          "cpu"]
    monkeypatch.chdir(tdir)
    one = _port_cli("calc_metrics").main(cm + ["--gpu_id", "0"])
    two = _port_cli("calc_metrics").main(cm + ["--gpu_id", "0 1"])
    assert one == two == _read_kv(os.path.join(out, "all_metrics.txt"))
    assert {"psnr", "ssim"} <= set(one)
