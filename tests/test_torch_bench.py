"""The port's benchmark (pixelnerf_yolo_torch/bench.py) against the repo's
bench.py: the configs, metric names and units, each render config's conf
and its ``field_flops_per_ray``, the record of each render config run on
the CPU at a toy size, the DTU trajectory's rays, the bounded run's
ordering and exit codes, and that the port's bench imports no JAX.

The render configs run in this process (BENCH_DEVICE=cpu); bench.py's
confs are built here as bench.py builds them (``__graft_entry__._flagship``
and the puts of ``bench.py:330-361``), since bench.py builds them inline."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import bench as jbench  # the repo's bench.py; its JAX imports are lazy
from pixelnerf_yolo_torch import bench as pbench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RENDERS = [c for c in jbench.ALL_CONFIGS if c in jbench.RENDER_METRIC_NAMES]
TOY = {"BENCH_DEVICE": "cpu", "BENCH_RAYS": "16", "BENCH_ITERS": "1",
       "BENCH_NO_PROBE": "1"}
RECORD_KEYS = {"metric", "value", "unit", "vs_baseline",
               "flops_per_ray_reference_alg", "flops_per_ray_executed",
               "device", "iters", "ms_median", "ms_min", "ms_max",
               "kernel_launches"}


def jax_render_conf(cfg, dtype="bfloat16"):
    """bench.py's conf of a render config (``bench.py:330-361``, no env)."""
    from __graft_entry__ import _flagship

    yolo = cfg.startswith("yolo")
    conf = _flagship(compute_dtype=dtype, yolo=yolo,
                     backbone="custom" if yolo else "resnet34")
    if cfg == "dtu_video":
        conf.put("renderer.white_bkgd", False)
    if cfg == "nerf_coarse":
        conf.put("renderer.n_fine", 0)
        conf.put("renderer.n_fine_depth", 0)
        conf.put("model.mlp_fine.type", "empty")
    if cfg in ("nerf_int8", "nerf_serve8"):
        conf.put("model.latent_int8", True)
    if cfg == "nerf_et":
        conf.put("renderer.early_terminate", 0.375)
    if cfg in ("nerf_w8a8", "nerf_serve8", "yolo_w8a8"):
        conf.put("model.mlp_int8", True)
    return conf


def jax_ns(cfg):
    """bench.py's NS (``bench.py:365``)."""
    return 3 if cfg in ("nerf_mv", "yolo", "yolo_w8a8", "dtu_video") else 1


def test_configs_and_constants():
    assert pbench.ALL_CONFIGS == jbench.ALL_CONFIGS
    assert pbench.CPU_CONFIGS == jbench.CPU_CONFIGS
    assert pbench.RENDER_METRIC_NAMES == jbench.RENDER_METRIC_NAMES
    assert pbench.UNIT_TRAIN == jbench.UNIT_TRAIN
    assert pbench.BASELINE_RAYS_PER_SEC == jbench.BASELINE_RAYS_PER_SEC
    assert all(pbench.MULTI_VIEW.count(c) == (jax_ns(c) == 3)
               for c in RENDERS)


@pytest.mark.parametrize("cfg", jbench.ALL_CONFIGS)
def test_metric_name_and_unit(cfg):
    assert pbench.metric_name_for(cfg) == jbench.metric_name_for(cfg)
    assert pbench.unit_for(cfg) == jbench.unit_for(cfg)


@pytest.fixture
def toy_env(monkeypatch):
    for key in ("BENCH_FUSED", "BENCH_INT8", "BENCH_W8A8", "BENCH_ET",
                "BENCH_EBS", "BENCH_TRACE", "BENCH_DTYPE", "PEAK_FLOPS"):
        monkeypatch.delenv(key, raising=False)
    for key, value in TOY.items():
        monkeypatch.setenv(key, value)
    return monkeypatch


def test_render_confs_are_bench_py_confs(toy_env):
    for cfg in RENDERS:
        got = pbench.render_conf(cfg, "bfloat16").to_dict()
        assert got == jax_render_conf(cfg).to_dict(), cfg


@pytest.mark.parametrize("cfg", [c for c in RENDERS if c != "dtu_video"])
def test_render_record_on_cpu(cfg, toy_env, capsys):
    if cfg in ("nerf_w8a8", "yolo"):  # the plain route too
        toy_env.setenv("BENCH_FUSED", "false")
    rec = pbench.run_config(cfg)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == rec
    assert RECORD_KEYS <= set(rec), RECORD_KEYS - set(rec)
    assert rec["metric"] == jbench.RENDER_METRIC_NAMES[cfg].replace(
        "_chip", "_cpu")
    assert "_cpu" in rec["metric"] and rec["unit"] == "rays/s"
    assert rec["device"] == "cpu" and rec["value"] > 0
    assert rec["iters"] == 1 and rec["kernel_launches"] == {}
    assert not [k for k in rec if k.startswith(("mfu_", "probe_"))]
    # the port's field FLOPs a ray: bench.py's formula on bench.py's conf
    assert rec["flops_per_ray_reference_alg"] == int(
        jbench.field_flops_per_ray(jax_render_conf(cfg), jax_ns(cfg)))
    assert rec["flops_per_ray_executed"] > 0


def test_dtu_video_rays_and_flops():
    """dtu_video without rendering it: its trajectory's 6 frames x 120,000
    rays equal bench.py's (``bench.py:388-399``), and its field FLOPs a
    ray."""
    import jax.numpy as jnp
    import torch

    from pixelnerf_yolo_tpu.utils.camera import dtu_trajectory, gen_rays

    rays, frames = pbench.dtu_rays(5, "cpu")
    assert frames == 6 and tuple(rays.shape) == (1, 6 * 120_000, 8)
    c = jnp.asarray(np.array([200.0, 150.0], np.float32))
    want = gen_rays(jnp.asarray(dtu_trajectory(5)), 400, 300,
                    jnp.asarray(np.array([437.0, 437.0], np.float32)),
                    1.2, 4.0, c=c).reshape(1, -1, 8)
    np.testing.assert_allclose(rays.numpy(), np.asarray(want), atol=1e-5)
    assert rays.dtype == torch.float32
    conf = pbench.render_conf("dtu_video", "bfloat16")
    assert pbench.field_flops_per_ray(conf, 3) == int(
        jbench.field_flops_per_ray(jax_render_conf("dtu_video"), 3))


def _jax_train_conf(cfg):
    """bench.py's train confs (``bench.py:612-638``) and its scaling model
    (``bench.py:989``)."""
    from __graft_entry__ import _DRYRUN_YOLO_CONF, _flagship
    from pixelnerf_yolo_tpu.config.hocon import parse_string

    if cfg == "scaling":
        return _flagship(d_hidden=64, backbone="resnet18", num_layers=2,
                         compute_dtype="float32")
    conf = parse_string(_DRYRUN_YOLO_CONF)
    if cfg == "train_yolo":
        conf.put("model.compute_dtype", "bfloat16")
        conf.put("model.mlp_coarse.d_hidden", 512)
        conf.put("model.mlp_coarse.n_blocks", 5)
        conf.put("model.encoder.backbone", "custom")
        conf.put("model.encoder.num_layers", 4)
        conf.put("renderer.n_coarse", 128)
        return conf
    flag = _flagship(compute_dtype="bfloat16")
    for k in ("model", "renderer"):
        conf.put(k, flag.get_config(k))
    return conf


@pytest.mark.parametrize("cfg,ns", [("train_yolo", 3), ("train_nerf", 1),
                                    ("scaling", 1)])
def test_train_and_scaling_field_flops(cfg, ns):
    from pixelnerf_yolo_torch.config.flagship import (flagship_conf,
                                                      train_nerf_conf,
                                                      train_yolo_conf)

    conf = {"train_yolo": lambda: train_yolo_conf("bfloat16"),
            "train_nerf": lambda: train_nerf_conf("bfloat16"),
            "scaling": lambda: flagship_conf(
                d_hidden=64, backbone="resnet18", num_layers=2,
                compute_dtype="float32")}[cfg]()
    assert pbench.field_flops_per_ray(conf, ns) == int(
        jbench.field_flops_per_ray(_jax_train_conf(cfg), ns))


def _stub_run(monkeypatch, fail=(), calls=None):
    """The outer run with the probe, the build and the config subprocesses
    stubbed: each config prints a record naming it, those in fail fail."""
    calls = [] if calls is None else calls
    monkeypatch.setattr(pbench, "_probe_with_retry", lambda t: None)
    monkeypatch.setattr(pbench, "_build_kernels", lambda t: None)

    def run(cfg, timeout_s):
        calls.append(cfg)
        if cfg in fail:
            return False, ["Traceback: boom"], "rc=1"
        return True, [json.dumps({"metric": cfg, "value": 1.0})], "rc=0"

    monkeypatch.setattr(pbench, "_run_config_subprocess", run)
    for key in ("BENCH_CONFIG", "BENCH_DEVICE", "BENCH_TOTAL_BUDGET_S"):
        monkeypatch.delenv(key, raising=False)
    return calls


def _records(out):
    return [json.loads(ln) for ln in out.strip().splitlines()]


def test_outer_run_orders_and_reprints_the_headline(monkeypatch, capsys):
    calls = _stub_run(monkeypatch, fail=("train_yolo",))
    assert pbench._outer_main() == 1  # an optional config failed
    recs = _records(capsys.readouterr().out)
    assert calls == [pbench.REQUIRED, *pbench.OPTIONALS]
    assert recs[0]["metric"] == "nerf" and recs[-1]["metric"] == "nerf"
    # after each optional record (or its error record), the headline
    assert [r["metric"] for r in recs[1::2]] == [
        c if c != "train_yolo" else pbench.metric_name_for(c)
        for c in pbench.OPTIONALS]
    assert all(r["metric"] == "nerf" for r in recs[2::2])
    err = recs[1 + 2 * pbench.OPTIONALS.index("train_yolo")]
    assert err["unit"] == jbench.unit_for("train_yolo") and "error" in err


def test_outer_run_skips_for_budget_and_retries_once(monkeypatch, capsys):
    calls = _stub_run(monkeypatch)
    monkeypatch.setenv("BENCH_TOTAL_BUDGET_S", "300")
    assert pbench._outer_main() == 0  # skipped is not failed
    out = capsys.readouterr()
    assert calls == ["nerf"] and len(_records(out.out)) == 1
    assert out.err.count("skipping optional") == len(pbench.OPTIONALS)

    calls = _stub_run(monkeypatch, fail=("yolo",))
    monkeypatch.setenv("BENCH_CONFIG", "yolo")
    assert pbench._outer_main() == 2  # the required config failed twice
    assert calls == ["yolo", "yolo"]
    rec = _records(capsys.readouterr().out)[-1]
    assert rec["metric"] == jbench.metric_name_for("yolo") and "error" in rec


def test_no_card_exits_2_with_an_error_record(monkeypatch, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BENCH_", "PNY_BENCH"))}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    run = subprocess.run([sys.executable, "-m", "pixelnerf_yolo_torch.bench"],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=120)
    assert run.returncode == 2, run.stderr[-2000:]
    rec = json.loads(run.stdout.strip().splitlines()[-1])
    assert rec["metric"] == jbench.metric_name_for("nerf")
    assert rec["unit"] == "rays/s" and rec["value"] == 0.0
    assert "no CUDA device" in rec["error"]
    # a config's own process refuses too, with its config's unit
    for key in list(os.environ):
        if key.startswith("BENCH_"):
            monkeypatch.delenv(key)
    monkeypatch.setenv("BENCH_INNER", "1")
    monkeypatch.setenv("BENCH_CONFIG", "train_yolo")
    assert pbench.main() == 2
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["unit"] == jbench.UNIT_TRAIN and "error" in rec


def test_imports_no_jax():
    code = ("import os, sys, json\n"
            "from pixelnerf_yolo_torch import bench\n"
            "bench.run_config('nerf_coarse')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'pixelnerf_yolo_tpu', "
            "'__graft_entry__', 'bench', 'synth_data'))\n"
            "print(json.dumps(bad))\n")
    env = dict(os.environ, **TOY)
    env.update(BENCH_RAYS="4", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=180)
    assert run.returncode == 0, run.stderr[-2000:]
    lines = run.stdout.strip().splitlines()
    assert json.loads(lines[-2])["metric"] == \
        "render_rays_per_sec_cpu_coarse_only"
    assert json.loads(lines[-1]) == []


def test_trace_of_the_timed_iterations(toy_env, tmp_path, capsys):
    """BENCH_TRACE=<dir>: a torch.profiler trace of the timed iterations
    that profile_trace's reduction reads, and "traced" in the record."""
    from pixelnerf_yolo_torch import profile_trace as pt

    toy_env.setenv("BENCH_TRACE", str(tmp_path))
    toy_env.setenv("BENCH_ITERS", "2")
    rec = pbench.run_config("nerf_coarse")
    assert rec["traced"] is True and rec["iters"] == 2
    path = pt.find_trace(str(tmp_path))
    meta = json.loads(open(path + ".meta.json").read())
    assert meta["iters"] == 2 and meta["config"] == "nerf_coarse"
    red = pt.reduce(pt.load_trace(path), meta["iters"])
    assert red.where == "host" and "model_inference" in red.stages
