"""The port's benchmark (pixelnerf_yolo_torch/bench.py): ``scaling`` and
``train_scaling`` at world sizes 1 and 2 (gloo ranks on the CPU, started
by ``parallel.launch``) in a subprocess with a timeout, their records
against the metric names and units of the repo's bench.py."""

import json
import os
import subprocess
import sys

import bench as jbench  # the repo's bench.py; its JAX imports are lazy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_scaling_records_at_worlds_1_and_2():
    code = ("from pixelnerf_yolo_torch import bench\n"
            "bench.run_scaling_bench(worlds=(1, 2))\n"
            "bench.run_train_scaling_bench(worlds=(1, 2))\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(BENCH_SCALING_RAYS="64", BENCH_ITERS="1", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=400)
    assert run.returncode == 0, run.stderr[-3000:]
    recs = [json.loads(ln) for ln in run.stdout.splitlines()
            if ln.startswith("{")]
    assert len(recs) == 2
    scaling, train = recs
    assert scaling["metric"] == "weak_scaling_sharding_efficiency_8dev_virtual"
    assert scaling["unit"] == jbench.unit_for("scaling")
    assert set(scaling["per_device_rays_per_sec"]) == {"1", "2"}
    assert all(v > 0 for v in scaling["per_device_rays_per_sec"].values())
    assert scaling["value"] > 0 and scaling["device"] == "cpu"
    assert train["metric"] == "sharded_train_weak_scaling_8dev_virtual"
    assert train["unit"] == jbench.unit_for("train_scaling")
    for mode in ("train_nerf", "train_yolo"):
        rates = train["total_work_per_sec"][mode]
        assert set(rates) == {"1", "2"} and all(v > 0 for v in rates.values())
    assert train["value"] > 0 and train["yolo_efficiency"] > 0
