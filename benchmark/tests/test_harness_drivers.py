"""Every driver at test size on the CPU through the harness's run, in
float32 against the reference; the result line's schema."""

import json
import math
import time

import pytest

from conftest import tiny_cell

E2E = {"srn_views": "rays_per_s", "yolo_train": "train_steps_per_s",
       "yolo_detect": "view_p95_ms"}


def run(cell, trace=False, driver=None, seconds=0.3):
    from benchmark import harness

    return harness.execute(cell, 2 ** 33 + 17, seconds, trace, "cpu",
                           time.perf_counter(), driver=driver)


@pytest.mark.parametrize("name", sorted(E2E))
def test_driver_agrees_with_reference(name):
    cell = tiny_cell(name)
    res = run(cell)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {E2E[name], "setup_s"}
    assert res["attempted"] >= 1 and res["failed"] == 0
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]
    # the line is strict JSON, its check numbers come last
    line = json.dumps(res)
    assert list(json.loads(line)) == ["correct", "attempted", "failed",
                                      "metrics", "device", "checks"]
    for m in res["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] > 0


@pytest.mark.parametrize("name", sorted(E2E))
def test_traced_run(name):
    res = run(tiny_cell(name), trace=True)
    assert res["correct"]
    assert set(res["device"]) >= {"busy_s", "window_s"}
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # on the CPU no kernel runs: the readers of device stages read
    # nothing and leave their metric out; a share of the peak stays
    # within 100%
    mfu = [k for k in res["metrics"] if k.startswith("mfu.")]
    assert len(mfu) == 1 and 0 < res["metrics"][mfu[0]]["value"] <= 100
    assert not any(k.endswith("_roofline") for k in res["metrics"])


def test_no_card_no_result(capsys):
    """Without a card the run exits non-zero and prints no result."""
    import torch

    from benchmark import harness

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = harness.main(["--workload", "srn_views", "--seed", "1",
                       "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_checkout_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark runs no
    cell: the program is not there."""
    import shutil
    import subprocess
    import sys

    from conftest import ROOT

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    code = ("import sys, time; sys.path.insert(0, '.');"
            "from benchmark import harness;"
            "c = harness.load_cell('yolo_detect');"
            "harness.execute(c, 1, 0.1, False, 'cpu', time.perf_counter())")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
    assert "pixelnerf_yolo_torch" in p.stderr
