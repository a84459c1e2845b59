"""The port's seven evaluation CLIs (``python -m
pixelnerf_yolo_torch.eval.<name>``) against the repo's eval/*.py on the
CPU, on tiny synthetic datasets, with the weights of one JAX init written
in each package's checkpoint format and the JAX CLI's draws fed to the
port's renders (``_jax_nerf_draws``, ``_jax_yolo_draws``): PSNR within 1e-4
dB, SSIM and LPIPS within 1e-6, F1 and the printed table exactly, mAP
within 1e-6, and the same output files by name."""

import builtins
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from synth_data import make_dvr_dataset, make_yolo_dataset
from test_eval_cli import EVAL_CONF
from test_lpips import synth_weights
from test_train_integration import YOLO_TRAIN_CONF
from torch_parity import (jax_draws, jax_yolo_draws, perturbed_variables,
                          port_model)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PSNR_TOL = 1e-4
SSIM_TOL = 1e-6
MAP_TOL = 1e-6
NAME = "cli"

# a 2-scale YOLO conf (32 and 16 px cells) with cross-scale suppression
YOLO_2SCALE_CONF = (
    YOLO_TRAIN_CONF.replace("num_scales = 1", "num_scales = 2")
    .replace("cell_sizes = [32]", "cell_sizes = [32, 16]\n"
             "        cross_scale_nms_iou = 0.35"))


def _load_jax_cli(script):
    spec = importlib.util.spec_from_file_location(
        "jax_cli_" + script, os.path.join(REPO, "eval", script + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_cli(name):
    return importlib.import_module("pixelnerf_yolo_torch.eval." + name)


def _write_weights(tmp, conf_text, images):
    """One JAX init (perturbed) saved as checkpoints/<NAME>/
    pixel_nerf_latest under tmp/jax in the JAX format and under tmp/port
    in the port's; returns (jax dir, port dir)."""
    import argparse

    from pixelnerf_yolo_tpu.config.hocon import parse_string
    from pixelnerf_yolo_tpu.models import make_model
    from pixelnerf_yolo_tpu.train import checkpoints as jck
    from pixelnerf_yolo_torch.config.hocon import parse_string as tparse
    from pixelnerf_yolo_torch.train import checkpoints as tck

    jm = make_model(parse_string(conf_text).get_config("model"))
    v = perturbed_variables(jm, images)
    dirs = []
    for side in ("jax", "port"):
        d = os.path.join(tmp, side)
        args = argparse.Namespace(
            checkpoints_path=os.path.join(d, "checkpoints"), name=NAME)
        if side == "jax":
            jck.save_weights(args, jax.tree.map(jnp.asarray, v))
        else:
            tck.save_weights(args, port_model(tparse(conf_text), v))
        with open(os.path.join(d, "run.conf"), "w") as f:
            f.write(conf_text)
        dirs.append(d)
    return dirs


@pytest.fixture(scope="module")
def nerf_setup(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("eval_cli_nerf"))
    root = os.path.join(tmp, "dvr")
    for stage in ("train", "val", "test"):
        make_dvr_dataset(root, stage=stage, n_cats=1, n_objs=2, n_views=4,
                         img_size=16)
    jdir, tdir = _write_weights(tmp, EVAL_CONF,
                                np.zeros((1, 3, 16, 16), np.float32))
    return root, jdir, tdir


@pytest.fixture(scope="module")
def yolo_setup(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("eval_cli_yolo"))
    root = make_yolo_dataset(os.path.join(tmp, "data"), n_scenes=2,
                             n_views=4, img_size=64, randomize=True, seed=3)
    jdir, tdir = _write_weights(tmp, YOLO_2SCALE_CONF,
                                np.zeros((3, 3, 32, 32), np.float32))
    return root, jdir, tdir


from pixelnerf_yolo_torch.render.nerf import NeRFRenderer  # noqa: E402
from pixelnerf_yolo_torch.render.yolo import YoloRenderer  # noqa: E402

_ORIG_DRAW = NeRFRenderer.draw
_ORIG_YOLO_CALL = YoloRenderer.__call__


def _jax_nerf_draws(seed):
    """A ``NeRFRenderer.draw`` for the port that makes the draws of the
    JAX CLI's render calls: its key PRNGKey(seed), split once per call."""
    state = {"key": jax.random.PRNGKey(seed)}

    def draw(renderer, n_rows, generator=None, device=None, train=False):
        state["key"], sub = jax.random.split(state["key"])
        want = _ORIG_DRAW(renderer, n_rows, None, "cpu", train)
        d = jax_draws(renderer, sub, n_rows, train)
        return {k: torch.from_numpy(d[k]) for k in want}

    return draw


def _jax_yolo_draws(seed=0):
    """A ``YoloRenderer.__call__`` for the port with the coarse draws of
    the JAX trainer's renders: its key PRNGKey(seed + 2), split per
    render."""
    state = {"key": jax.random.PRNGKey(seed + 2)}

    def call(renderer, model, cond, rays, generator=None, u=None):
        state["key"], sub = jax.random.split(state["key"])
        n = torch.as_tensor(rays).reshape(-1, 8).shape[0]
        u = torch.from_numpy(jax_yolo_draws(sub, n, renderer.n_coarse))
        return _ORIG_YOLO_CALL(renderer, model, cond, rays, u=u)

    return call


def _run(monkeypatch, capsys, cwd, fn):
    monkeypatch.chdir(cwd)
    capsys.readouterr()
    fn()
    return capsys.readouterr().out


def _jax_main(monkeypatch, script, argv):
    def run():
        monkeypatch.setattr(sys, "argv", [script + ".py"] + argv)
        mod = _load_jax_cli(script)
        if script == "calc_metrics":  # parses argv at import
            mod.run_map()
            mod.run_reduce()
        else:
            mod.main()
    return run


def _final(out, key="final psnr"):
    line = [ln for ln in out.splitlines() if ln.startswith(key)][-1].split()
    return float(line[-3]), float(line[-1])  # psnr, ssim


def _files(d):
    return sorted(os.path.relpath(os.path.join(a, f), d)
                  for a, _, fs in os.walk(d) for f in fs)


def _nerf_argv(root, extra):
    return ["-n", NAME, "-c", "run.conf", "-D", root, "-F", "dvr",
            "--ray_batch_size", "96"] + extra


@pytest.mark.parametrize("extra", [
    ["-P", "0"],
    ["-P", "1 2", "--coarse", "--write_depth", "--write_compare",
     "--include_src"],
])
def test_eval_matches_jax(nerf_setup, monkeypatch, capsys, extra):
    root, jdir, tdir = nerf_setup
    argv = _nerf_argv(root, ["--split", "test", "-O", "out"] + extra)
    jout = _run(monkeypatch, capsys, jdir, _jax_main(monkeypatch, "eval",
                                                       argv))
    monkeypatch.setattr(NeRFRenderer, "draw", _jax_nerf_draws(0))
    tout = _run(monkeypatch, capsys, tdir, lambda: _port_cli("eval").main(
        argv + ["--device", "cpu"]))
    (jp, js), (tp, ts) = _final(jout), _final(tout)
    assert np.isfinite(jp)
    assert abs(tp - jp) <= PSNR_TOL and abs(ts - js) <= SSIM_TOL
    assert _files(os.path.join(tdir, "out")) == _files(
        os.path.join(jdir, "out"))
    # a second run resumes from finish.txt, renders nothing, same means
    tout = _run(monkeypatch, capsys, tdir, lambda: _port_cli("eval").main(
        argv + ["--device", "cpu"]))
    assert "(skip)" in tout
    assert abs(_final(tout)[0] - tp) <= 1e-9
    for d in (jdir, tdir):
        import shutil

        shutil.rmtree(os.path.join(d, "out"))


def test_eval_approx_matches_jax(nerf_setup, monkeypatch, capsys):
    root, jdir, tdir = nerf_setup
    argv = _nerf_argv(root, ["--split", "val", "-P", "0 1",
                             "--batch_size", "2"])
    jout = _run(monkeypatch, capsys, jdir,
                _jax_main(monkeypatch, "eval_approx", argv))
    monkeypatch.setattr(NeRFRenderer, "draw", _jax_nerf_draws(1234))
    tout = _run(monkeypatch, capsys, tdir,
                lambda: _port_cli("eval_approx").main(argv + ["--device",
                                                              "cpu"]))
    (jp, js), (tp, ts) = _final(jout), _final(tout)
    assert abs(tp - jp) <= PSNR_TOL and abs(ts - js) <= SSIM_TOL


def _capture_mimwrite(monkeypatch):
    import imageio

    frames = []
    orig = imageio.mimwrite

    def spy(path, ims, *a, **k):
        frames.append(np.asarray(ims))
        return orig(path, ims, *a, **k)

    monkeypatch.setattr(imageio, "mimwrite", spy)
    return frames


@pytest.mark.parametrize("extra", [["--radius", "1.3"],
                                   ["--dtu_trajectory"]])
def test_gen_video_matches_jax(nerf_setup, monkeypatch, capsys, extra):
    root, jdir, tdir = nerf_setup
    argv = _nerf_argv(root, ["--split", "test", "-P", "0", "--num_views",
                             "5"] + extra)
    frames = _capture_mimwrite(monkeypatch)
    _run(monkeypatch, capsys, jdir, _jax_main(monkeypatch, "gen_video", argv))
    monkeypatch.setattr(NeRFRenderer, "draw", _jax_nerf_draws(0))
    _run(monkeypatch, capsys, tdir, lambda: _port_cli("gen_video").main(
        argv + ["--device", "cpu"]))
    jf, tf = frames[-2], frames[-1]
    assert jf.shape == tf.shape and jf.shape[0] in (5, 6)
    assert np.abs(jf.astype(int) - tf.astype(int)).max() <= 1
    assert _files(os.path.join(tdir, "visuals", NAME)) == _files(
        os.path.join(jdir, "visuals", NAME))


def test_eval_real_matches_jax(nerf_setup, monkeypatch, capsys):
    _, jdir, tdir = nerf_setup
    sample = os.path.join(REPO, "input", "toyota_normalize.png")
    argv = ["-n", NAME, "-c", "run.conf", "--input", sample, "--output",
            "real", "--size", "16", "--out_size", "12", "--num_views", "3",
            "--gif", "--ray_batch_size", "96"]
    _run(monkeypatch, capsys, jdir, _jax_main(monkeypatch, "eval_real", argv))
    monkeypatch.setattr(NeRFRenderer, "draw", _jax_nerf_draws(0))
    _run(monkeypatch, capsys, tdir, lambda: _port_cli("eval_real").main(
        argv + ["--device", "cpu"]))
    jreal, treal = os.path.join(jdir, "real"), os.path.join(tdir, "real")
    assert _files(treal) == _files(jreal)
    import imageio.v2 as imageio

    for f in _files(jreal):
        if f.endswith(".png"):
            a = imageio.imread(os.path.join(jreal, f)).astype(int)
            b = imageio.imread(os.path.join(treal, f)).astype(int)
            assert np.abs(a - b).max() <= 1, f


def test_calc_metrics_matches_jax(nerf_setup, monkeypatch, capsys, tmp_path):
    """The map and reduce phases over one eval output, with LPIPS from a
    random-weight lpips_vgg.npz in both packages."""
    root, jdir, tdir = nerf_setup
    vgg_sd, lin_sd = synth_weights(np.random.default_rng(0), scale=0.05)
    np.savez(tmp_path / "lpips_vgg.npz", **vgg_sd, **lin_sd)
    monkeypatch.setenv("PNY_PRETRAINED_DIR", str(tmp_path))
    argv = _nerf_argv(root, ["--split", "test", "-O", "out", "-P", "0"])
    monkeypatch.setattr(NeRFRenderer, "draw", _jax_nerf_draws(0))
    _run(monkeypatch, capsys, tdir, lambda: _port_cli("eval").main(
        argv + ["--device", "cpu"]))
    out = os.path.join(tdir, "out")
    cm = ["-D", root, "-O", out, "-F", "dvr", "--overwrite"]
    _run(monkeypatch, capsys, tdir, _jax_main(monkeypatch, "calc_metrics",
                                              cm))
    want = _read_kv(os.path.join(out, "all_metrics.txt"))
    got = _port_cli("calc_metrics").main(cm + ["--device", "cpu"])
    assert set(got) == set(want) == {"psnr", "ssim", "lpips"}
    assert got == _read_kv(os.path.join(out, "all_metrics.txt"))
    assert abs(got["psnr"] - want["psnr"]) <= PSNR_TOL
    assert abs(got["ssim"] - want["ssim"]) <= SSIM_TOL
    assert abs(got["lpips"] - want["lpips"]) <= SSIM_TOL
    assert want["lpips"] > 0


def _read_kv(path):
    with open(path) as f:
        return {k: float(v) for k, v in (ln.split() for ln in f)}


def _yolo_argv(root, extra=()):
    return ["-n", NAME, "-c", "run.conf", "-D", root, "-F", "yolo",
            "-V", "3"] + list(extra)


def _table(out, header):
    lines = out.splitlines()
    i = lines.index(header)
    rows = []
    for ln in lines[i + 1:]:
        if not ln or ("\t" not in ln and not ln.startswith("  AP")):
            break
        rows.append(ln)
    return rows


@pytest.mark.parametrize("extra", [[], ["--calibrate_scales", "0.45,0.7"]])
def test_eval_yolo_matches_jax(yolo_setup, monkeypatch, capsys, extra):
    root, jdir, tdir = yolo_setup
    argv = _yolo_argv(root, extra)
    jout = _run(monkeypatch, capsys, jdir, _jax_main(monkeypatch, "eval_yolo",
                                                       argv))
    monkeypatch.setattr(YoloRenderer, "__call__", _jax_yolo_draws())
    tout = _run(monkeypatch, capsys, tdir, lambda: _port_cli(
        "eval_yolo").main(argv + ["--device", "cpu"]))
    header = "taus\tP\tR\tF1\tmAP@0.5\tTP/FP/FN" if extra else \
        "Precision\tRecall\tF1\tmAP@0.5"
    jrows, trows = _table(jout, header), _table(tout, header)
    assert len(trows) == len(jrows) == (4 if extra else 1 + 2)
    if extra:
        assert trows == jrows
        best = [ln for ln in jout.splitlines() if ln.startswith("best per")]
        assert best and best[0] in tout.splitlines()
        return
    jv, tv = jrows[0].split("\t"), trows[0].split("\t")
    assert tv[:3] == jv[:3]  # precision, recall, F1 exactly
    assert abs(float(tv[3]) - float(jv[3])) <= MAP_TOL
    assert trows[1:] == jrows[1:]  # per-class AP


def test_gen_images_yolo_matches_jax(yolo_setup, monkeypatch, capsys):
    root, jdir, tdir = yolo_setup
    argv = _yolo_argv(root, ["-P", "0 2 3", "--dest", "2"])

    def answers():
        it = iter(["0.45", "0.75", "0.6", "0.5", "q"])
        monkeypatch.setattr(builtins, "input", lambda *a: next(it))

    answers()
    _run(monkeypatch, capsys, jdir, _jax_main(monkeypatch, "gen_images_yolo",
                                              argv))
    answers()
    monkeypatch.setattr(YoloRenderer, "__call__", _jax_yolo_draws())
    _run(monkeypatch, capsys, tdir, lambda: _port_cli(
        "gen_images_yolo").main(argv + ["--device", "cpu"]))
    jvis = os.path.join(jdir, "visuals", "yolo_vis")
    tvis = os.path.join(tdir, "visuals", "yolo_vis")
    assert _files(tvis) == _files(jvis) and len(_files(jvis)) == 2
    import imageio.v2 as imageio

    for f in _files(jvis):
        a = imageio.imread(os.path.join(jvis, f)).astype(int)
        b = imageio.imread(os.path.join(tvis, f)).astype(int)
        assert np.abs(a - b).max() <= 1, f


PORT_CLIS = ["eval", "eval_approx", "eval_real", "gen_video", "eval_yolo",
             "gen_images_yolo"]


@pytest.mark.parametrize("name", PORT_CLIS)
def test_cli_defaults_to_the_card(nerf_setup, monkeypatch, name):
    """Without --device each CLI runs on cuda."""
    from pixelnerf_yolo_torch.config.args import parse_args

    _, _, tdir = nerf_setup
    monkeypatch.chdir(tdir)
    args, _ = parse_args(_port_cli(name).extra_args,
                         argv=["-n", NAME, "-c", "run.conf"])
    assert args.device == "cuda"
    cm = _port_cli("calc_metrics").make_parser().parse_args(["-D", "x"])
    assert cm.device == "cuda"


def test_cli_without_device_needs_the_card(nerf_setup, monkeypatch):
    """On a machine without a card, a CLI given no --device fails instead
    of moving to the CPU."""
    root, _, tdir = nerf_setup
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.chdir(tdir)
    with pytest.raises((RuntimeError, AssertionError)):
        _port_cli("eval_approx").main(_nerf_argv(root, ["-P", "0"]))
