"""The port's benchmark (pixelnerf_yolo_torch/bench.py) on the CPU: the
records of ``train_yolo``, ``train_nerf`` and ``serve_artifact`` at toy
sizes (BENCH_DEVICE=cpu), in this process, against the fields and units
of the repo's bench.py."""

import json

import pytest

import bench as jbench  # the repo's bench.py; its JAX imports are lazy
from pixelnerf_yolo_torch import bench as pbench

TRAIN_KEYS = {"metric", "value", "unit", "vs_baseline", "ms_per_step",
              "rays_per_step", "rays_trained_per_sec",
              "flops_per_step_executed", "device", "iters", "ms_median",
              "ms_min", "ms_max", "kernel_launches"}


@pytest.fixture
def toy_env(monkeypatch):
    for key in ("BENCH_FUSED", "BENCH_REMAT", "BENCH_REMAT_POLICY",
                "BENCH_REMAT_GATHER", "BENCH_TRACE", "BENCH_DTYPE",
                "PEAK_FLOPS"):
        monkeypatch.delenv(key, raising=False)
    for key, value in {"BENCH_DEVICE": "cpu", "BENCH_RAYS": "16",
                       "BENCH_TRAIN_RAYS": "16", "BENCH_ITERS": "1",
                       "BENCH_NO_PROBE": "1"}.items():
        monkeypatch.setenv(key, value)
    return monkeypatch


def _last_record(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cfg,fused", [("train_yolo", "false"),
                                       ("train_nerf", "auto")])
def test_train_record_on_cpu(cfg, fused, toy_env, capsys):
    toy_env.setenv("BENCH_FUSED", fused)
    rec = pbench.run_config(cfg)
    assert _last_record(capsys) == rec
    assert TRAIN_KEYS <= set(rec), TRAIN_KEYS - set(rec)
    assert rec["metric"] == jbench.metric_name_for(cfg).replace("_chip",
                                                                "_cpu")
    assert rec["unit"] == jbench.UNIT_TRAIN and rec["device"] == "cpu"
    assert rec["value"] > 0 and rec["flops_per_step_executed"] > 0
    assert not [k for k in rec if k.startswith(("mfu_", "probe_"))]
    assert rec["kernel_launches"] == {}
    # NeRF: the -R rays of one scene; YOLO: the 16-ray chunks that hold the
    # scene's real rays
    if cfg == "train_nerf":
        assert rec["rays_per_step"] == 16
    else:
        assert rec["rays_per_step"] % 16 == 0
    # value is rounded to 3 decimals: compare with the median step time
    assert rec["rays_trained_per_sec"] == pytest.approx(
        rec["rays_per_step"] * 1e3 / rec["ms_median"], rel=1e-3, abs=0.05)


def test_serve_artifact_record_on_cpu(toy_env, capsys):
    rec = pbench.run_config("serve_artifact")
    assert _last_record(capsys) == rec
    assert rec["metric"] == "serve_artifact_rays_per_sec_cpu"
    assert rec["unit"] == "rays/s" and rec["device"] == "cpu"
    assert rec["value"] > 0 and rec["live_rays_per_sec"] > 0
    # the exported program is the live step's: bitwise
    assert rec["parity_max_abs_delta"] == 0.0
    assert rec["artifact_bytes"] > 0 and rec["platform"] == "cpu"
    assert not [k for k in rec if k.startswith(("mfu_", "probe_"))]
    assert rec["flops_per_ray_reference_alg"] == int(
        jbench.field_flops_per_ray(_jax_flagship(), 1))


def _jax_flagship():
    from __graft_entry__ import _flagship

    return _flagship(compute_dtype="bfloat16")
