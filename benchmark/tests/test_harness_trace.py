"""The trace reduction on a synthetic trace."""

import pytest

from benchmark import trace


def x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def kernel(ts, dur, corr, name="k"):
    return x(name, "kernel", ts, dur, tid=7, correlation=corr)


def launch(ts, corr):
    return x("cudaLaunchKernel", "cuda_runtime", ts, 1, correlation=corr)


EVENTS = [
    x("model_inference", "user_annotation", 0, 100),
    x("encoder_index", "user_annotation", 10, 20),
    launch(12, 1), kernel(40, 10, 1, "gather"),
    x("pixelnerf_yolo::full_pe", "cpu_op", 50, 10,
      **{"Input Dims": [[4096, 6], [4096, 512]]}),
    launch(52, 2), kernel(60, 30, 2, "full_pe_kernel"),
    # a backward launch on another thread, its node made by a forward op
    # with sequence number 9 inside encoder_index
    x("aten::gather", "cpu_op", 15, 2, **{"Sequence number": 9}),
    x("autograd::engine::evaluate_function: GatherBackward", "cpu_op", 200,
      30, tid=2, **{"Sequence number": 9}),
    x("cudaLaunchKernel", "cuda_runtime", 205, 1, tid=2, correlation=3),
    kernel(210, 20, 3, "scatter"),
    launch(300, 4), kernel(300, 10, 4, "loose"),
]


def test_stages_sum_to_busy_time_and_idle_share():
    red = trace.reduce(EVENTS, (0, 400))
    assert red.stages == pytest.approx({
        "encoder_index": 10e-6, "model_inference": 30e-6,
        "bwd:encoder_index": 20e-6, "(no scope)": 10e-6})
    assert sum(red.stages.values()) == pytest.approx(red.busy_s)
    assert red.window_s == pytest.approx(400e-6)
    assert red.idle_share == pytest.approx(1 - 70 / 400)


def test_kernel_launches_carry_their_rows():
    red = trace.reduce(EVENTS, (0, 400))
    assert red.kernel_launches == [("full_pe", 4096, pytest.approx(30e-6))]


def test_window_and_idle_gaps():
    red = trace.reduce(EVENTS, (35, 260))
    assert red.busy_s == pytest.approx((10 + 30 + 20) * 1e-6)
    # by the innermost host range open on the main thread as each gap
    # opens: 35-40 and 90-210 in model_inference, 50-60 in the kernel op,
    # 230-260 in none
    assert red.idle_gaps == pytest.approx({
        "model_inference": 125e-6, "pixelnerf_yolo::full_pe": 10e-6,
        "(no host range)": 30e-6})
    assert sum(red.idle_gaps.values()) == pytest.approx(
        red.window_s - red.busy_s)


def test_overlapping_ops_count_once_in_busy_time():
    ev = [launch(0, 1), kernel(0, 10, 1), launch(1, 2), kernel(5, 10, 2)]
    red = trace.reduce(ev, (0, 20))
    assert red.busy_s == pytest.approx(15e-6)
    assert sum(red.ops.values()) == pytest.approx(20e-6)
