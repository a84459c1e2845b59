"""The port's trace tool (pixelnerf_yolo_torch/profile_trace.py).

The reduction on a synthetic trace shaped like ``torch.profiler``'s
Chrome export: ``user_annotation`` ranges (nested: the innermost wins),
``cuda_runtime`` launches and ``kernel`` events joined by correlation id,
a backward launch given to its forward op's scope through the shared
``Sequence number`` (``bwd:<scope>``), a remat replay's launch to the
range it re-enters on the autograd thread, ``(no scope)`` (a kernel in no
range, and one without a launch event), the busy time, the idle share and the report.  Then one
real capture of a small render on the CPU through ``python -m
pixelnerf_yolo_torch.profile_trace --device cpu`` and a ``--parse-only``
of the trace it wrote."""

import io
import json
import os
import subprocess
import sys

import pytest

from pixelnerf_yolo_torch import profile_trace as pt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _x(name, cat, ts, dur, tid=1, pid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "pid": pid, "args": args}


def _launch(ts, corr, tid=1):
    return _x("cudaLaunchKernel", "cuda_runtime", ts, 1, tid=tid,
              correlation=corr)


def _kernel(name, ts, dur, corr, stream=7):
    return _x(name, "kernel", ts, dur, tid=stream, pid=0, correlation=corr)


def synthetic_trace():
    return [
        _x(pt.ITERATION, "user_annotation", 0, 1000),
        _x("renderer_forward", "user_annotation", 0, 100),
        _x("model_inference", "user_annotation", 10, 50),
        _x("encoder_index", "user_annotation", 12, 8),
        _x("not_a_scope", "user_annotation", 13, 2),
        _launch(13, 1), _launch(30, 2), _launch(70, 3), _launch(150, 4),
        _x("aten::mm", "cpu_op", 35, 3, **{"Sequence number": 7,
                                          "Fwd thread id": 0}),
        _x("aten::relu", "cpu_op", 70, 3, **{"Sequence number": 8,
                                            "Fwd thread id": 0}),
        _x("autograd::engine::evaluate_function: MmBackward0", "cpu_op",
           400, 20, tid=2, **{"Sequence number": 7, "Fwd thread id": 1}),
        _launch(405, 5, tid=2),
        _kernel("gather", 200, 10, 1),
        _kernel("field_mlp_tc<512, 0>", 210, 20, 2),
        _kernel("sort", 230, 5, 3),
        _kernel("stray", 300, 10, 4),
        _kernel("mm_backward", 430, 30, 5),
        # no launch event for correlation 6
        _kernel("unlaunched", 500, 5, 6),
        # a remat replay: the scope re-entered on the autograd thread
        _x("autograd::engine::evaluate_function: CheckpointBackward",
           "cpu_op", 700, 50, tid=2, **{"Sequence number": 8,
                                       "Fwd thread id": 1}),
        _x("resblock", "user_annotation", 710, 20, tid=2),
        _launch(715, 9, tid=2),
        _kernel("replayed", 760, 10, 9),
        _x("cudaMemcpyAsync", "cuda_runtime", 600, 1, correlation=8),
        _x("Memcpy DtoH", "gpu_memcpy", 605, 10, tid=7, pid=0,
           correlation=8),
    ]


def test_attribution():
    ops, stages, where = pt.attribute(synthetic_trace())
    assert where == "device"
    got = {e["name"]: s for e, s in zip(ops, stages)}
    assert got == {"gather": "encoder_index",
                   "field_mlp_tc<512, 0>": "model_inference",
                   "sort": "renderer_forward", "stray": pt.NO_SCOPE,
                   "mm_backward": "bwd:model_inference",
                   "unlaunched": pt.NO_SCOPE, "replayed": "resblock",
                   "Memcpy DtoH": pt.NO_SCOPE}


def test_reduction_and_idle_share():
    red = pt.reduce(synthetic_trace(), iters=2)
    assert red.stages["model_inference"] == [0.01, 0.5]
    assert red.stages["bwd:model_inference"] == [0.015, 0.5]
    assert red.kernels[("encoder_index", "gather")] == [0.005, 0.5]
    # busy: the union of 200-235, 300-310, 430-460, 500-505, 605-615,
    # 760-770 us
    assert red.busy_ms == pytest.approx(0.1 / 2)
    assert red.stage_ms == pytest.approx(red.busy_ms)
    assert red.wall_ms == pytest.approx(0.5)
    assert red.idle_share == pytest.approx(1 - 0.1)


def test_overlapping_ops_count_once_in_busy_time():
    events = [_launch(1, 1), _launch(2, 2), _kernel("a", 10, 10, 1),
              _kernel("b", 15, 10, 2, stream=8)]
    red = pt.reduce(events)
    assert red.busy_ms == pytest.approx(0.015)
    assert red.stage_ms == pytest.approx(0.02)
    assert red.wall_ms == pytest.approx(0.015)  # no iteration ranges


def test_report():
    out = io.StringIO()
    red = pt.reduce(synthetic_trace(), iters=1)
    pt.print_report(red, {"model_inference": 4e9, "(backward)": 1e9}, top=3,
                    dtype="bfloat16", card="NVIDIA H100 80GB HBM3, 700.00 W",
                    out=out)
    text = out.getvalue()
    assert "model_inference" in text and "bwd:model_inference" in text
    assert "(no scope)" in text and "idle 90.0%" in text
    assert "no GB column" in text and "989 bf16 / 67 f32" in text
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in text
    # 4 GFLOP over model_inference's 0.02 ms: 200 TFLOP/s
    row = next(line for line in text.splitlines()
               if line.startswith("model_inference"))
    assert row.split()[-2:] == ["4.00", "200.00"]
    assert "(backward)" in text


def test_report_spans_and_counters():
    """The recorder's spans and counters beside the stage table."""
    from pixelnerf_yolo_torch.utils.profiling import Span

    recs = [Span("train_step", 0, 4_000_000, 0, -1, 0),
            Span("yolo_loss", 1_000_000, 2_500_000, 1, 0, 0),
            Span("yolo_loss", 3_000_000, 0, 2, 0, 0)]  # still open
    spans = pt.span_table(recs, iters=2)
    assert spans == {"train_step": [0.5, 2.0], "yolo_loss": [0.5, 0.75]}
    out = io.StringIO()
    pt.print_report(pt.reduce(synthetic_trace()), out=out, spans=spans,
                    counters={"syncs:yolo_loss": 1.5, "nms_rounds": 32})
    text = out.getvalue()
    assert "Program spans" in text and "syncs:yolo_loss" in text
    row = next(line for line in text.splitlines()
               if line.startswith("yolo_loss "))
    assert row.split() == ["yolo_loss", "0.5", "0.750"]


def test_cpu_capture_and_parse(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "pixelnerf_yolo_torch.profile_trace",
           "--config", "nerf", "--rays", "16", "--iters", "1", "--dtype",
           "float32", "--device", "cpu", "--outdir", str(tmp_path)]
    run = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=str(tmp_path), timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "host time per iteration" in run.stdout
    for stage in ("model_inference", "encoder_index", "renderer_forward"):
        assert f"\n{stage} " in run.stdout
    trace = tmp_path / "nerf_float32.trace.json"
    meta = json.loads((tmp_path / "nerf_float32.trace.json.meta.json")
                      .read_text())
    assert meta["device"] == "cpu" and meta["iters"] == 1
    assert meta["flops_by_stage"]["model_inference"] > 0
    parsed = subprocess.run(cmd[:3] + ["--parse-only", str(tmp_path)],
                            capture_output=True, text=True, env=env,
                            cwd=str(tmp_path), timeout=300)
    assert parsed.returncode == 0, parsed.stderr[-3000:]
    assert f"parsing {trace} (per iteration of 1)" in parsed.stdout
    assert "model_inference" in parsed.stdout


def test_no_card_refuses():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert pt.main(["--config", "nerf", "--rays", "4"]) == 1
