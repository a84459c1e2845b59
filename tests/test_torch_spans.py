"""The port's span and counter recorder (utils/profiling.py).

(a) With recording off a scope enters no ``record_function`` range and
records nothing, and ``count_flops``' stages are the JAX cut points alone,
the same with recording on.  (b) Under a CPU ``torch.profiler`` capture
of a small YOLO encode and render, ``decode_cells`` and ``nms_padded``:
the spans and their parents, each span against its ``user_annotation``
event in the exported trace of one capture (inside the event, the median
span within 200 us of it at the start and 10% + 100 us in duration),
``nms_rounds`` 32 where boxes pass and 0 where none does.  (c) One small
YOLO ``train_step`` is one ``train_step`` root over ``batch_assemble``,
``yolo_loss`` and ``optimizer``, and its backward's FLOPs stay
``(backward)``'s.  (d) Spans past the bound are counted as
dropped, and the benchmark's readers then read nothing.  (e) A sync
warning counts against the innermost open span, and not at all outside
every span (driven through the warnings hook: the CPU makes no syncs)."""

import json
import warnings

import numpy as np
import pytest
import torch

from pixelnerf_yolo_torch.utils import profiling
from pixelnerf_yolo_torch.utils.profiling import (KNOWN_SCOPES, PORT_SPANS,
                                                  by_stage, count_flops,
                                                  scope)
from synth_data import make_yolo_dataset
from torch_parity import one_torch_thread  # noqa: F401
from torch_parity import small_yolo, yolo_scene

SYNC = profiling.SYNC_WARNING + " (Triggered internally at CUDAFunctions.cpp)"
# a span's clock is read just inside its range, so it lies inside its
# trace event, within the clocks' rounding (EDGE_US); entering or leaving a
# range under this suite's CPU profiler takes 10-70 us, but now and then
# the profiler grows its event lists inside a range, up to 1.5 ms: the
# median span is held to 200 us and 10% + 100 us, each to STALL_US
EDGE_US, STALL_US = 50, 5000


@pytest.fixture(scope="module")
def yolo():
    """A small YOLO model and renderer on the CPU (seeded init), its
    scene's condition inputs and 24 cell rays."""
    from pixelnerf_yolo_torch.models import make_model
    from pixelnerf_yolo_torch.render import make_renderer

    conf = small_yolo(use_fused_mlp="false")
    model = make_model(conf.get_config("model"), device="cpu", seed=0)
    renderer = make_renderer(conf, device="cpu")
    images, poses, focal, c, _ = yolo_scene(size=32)
    rays = np.random.default_rng(0).normal(size=(24, 8)).astype(np.float32)
    rays[:, 6], rays[:, 7] = 1.0, 3.0
    return model, renderer, (images, poses, focal, c), torch.from_numpy(rays)


def detect(yolo, nms_threshold=0.0):
    """encode, render, decode_cells and nms_padded of the small scene."""
    from pixelnerf_yolo_torch.detect.nms import decode_cells, nms_padded

    model, renderer, (images, poses, focal, c), rays = yolo
    anchors = torch.tensor([[0.3, 0.3], [0.5, 0.5], [0.8, 0.8]])
    with torch.no_grad():
        cond = model.encode(images, poses, focal, c=c)
        out = renderer(model, cond, rays)
        cand = decode_cells(out.reshape(1, 4, 6, 3, 7), anchors)[0]
        return nms_padded(cand, 0.5, nms_threshold, 64)


def passing_boxes():
    """Four boxes apart from each other, every one above 0.5."""
    xy = torch.tensor([[0.2, 0.2], [0.7, 0.2], [0.2, 0.7], [0.7, 0.7]])
    return torch.cat([torch.zeros(4, 1), torch.full((4, 1), 0.9), xy,
                      torch.full((4, 2), 0.2)], 1)


def test_off_enters_no_range_and_records_nothing(yolo, monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def spy(name, *args):
        entered.append(name)
        return real(name, *args)

    profiling.reset()
    monkeypatch.setattr(torch.profiler, "record_function", spy)
    stages_off = by_stage(count_flops(detect, yolo)[1])
    assert entered == [] and profiling.records() == []
    assert profiling.counters() == {}
    monkeypatch.undo()
    with profiling.recording():
        stages_on = by_stage(count_flops(detect, yolo)[1])
        assert {r.name for r in profiling.records()} >= {
            "encode", "yolo_render", "decode_cells", "nms_padded"}
    assert stages_on == stages_off
    assert set(stages_off) <= set(KNOWN_SCOPES) | {profiling.NO_SCOPE}
    assert stages_off["model_inference"] > 0
    assert stages_off["encoder_trunk"] > 0


def capture(yolo, tmp_path):
    """The spans, counters and exported trace of a profiled detection of
    the small scene (no box passing) and an NMS of passing_boxes()."""
    from pixelnerf_yolo_torch.detect.nms import nms_padded

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        detect(yolo, nms_threshold=2.0)
        nms_padded(passing_boxes(), 0.5, 0.5, 64)
    recs, counts = profiling.records(), profiling.counters()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return recs, counts, json.loads(path.read_text())


def clock_gaps(recs, trace):
    """Each span against its user_annotation event: (span, us from the
    event's start to the span's, us from the span's end to the event's,
    event duration us)."""
    base = trace.get("baseTimeNanoseconds", 0)
    events = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            events.setdefault(e["name"], []).append(e)
    out = []
    for name in {r.name for r in recs}:
        spans = [r for r in recs if r.name == name]
        evs = sorted(events[name], key=lambda e: e["ts"])
        assert len(evs) == len(spans), name
        for r, e in zip(spans, evs):
            out.append((name, (r.start - base) / 1e3 - e["ts"],
                        e["ts"] + e["dur"] - (r.end - base) / 1e3, e["dur"]))
    return out


def test_profiled_detection_spans(yolo, tmp_path):
    detect(yolo)  # warm
    # a process's first profiler session pays the profiler's set-up inside
    # its first range (1.4 ms on this suite's CPU): one session first
    capture(yolo, tmp_path)
    recs, counts, trace = capture(yolo, tmp_path)
    assert counts["nms_rounds"] == 32 and profiling.dropped() == 0
    names = [r.name for r in recs]
    for name in ("encode", "encoder_trunk", "yolo_render", "model_inference",
                 "yolo_aggregate", "decode_cells", "nms_padded"):
        assert name in names
    assert names.count("nms_padded") == 2
    for r in recs:
        assert r.end >= r.start > 0 and recs[r.index] is r
        assert r.root == (r.index if r.parent < 0 else recs[r.parent].root)
    parent = {r.name: recs[r.parent].name if r.parent >= 0 else None
              for r in recs}
    assert parent["encode"] is None and parent["encoder_trunk"] == "encode"
    assert parent["yolo_render"] is None
    assert parent["model_inference"] == "yolo_render"
    assert parent["yolo_aggregate"] == "yolo_render"
    assert parent["decode_cells"] is None and parent["nms_padded"] is None

    gaps = clock_gaps(recs, trace)
    outside = [g for g in gaps if min(g[1], g[2]) < -EDGE_US
               or max(g[1], g[2]) > STALL_US]
    assert not outside, outside
    assert np.median([g[1] for g in gaps]) <= 200, gaps
    assert np.median([g[1] + g[2] - 0.1 * g[3] for g in gaps]) <= 100, gaps

    # no box passes: the loop runs no round
    with profiling.recording():
        detect(yolo, nms_threshold=2.0)
        assert profiling.counters().get("nms_rounds", 0) == 0
        assert [r.name for r in profiling.records()].count("nms_padded") == 1


def test_train_step_is_one_root(tmp_path):
    from pixelnerf_yolo_torch.config.hocon import parse_string
    from pixelnerf_yolo_torch.data import DataLoader, get_split_dataset
    from pixelnerf_yolo_torch.models import make_model
    from pixelnerf_yolo_torch.render import make_renderer
    from pixelnerf_yolo_torch.train import make_trainer
    from torch_parity import train_args, yolo_train_conf

    root = make_yolo_dataset(str(tmp_path / "data"), n_scenes=1, n_views=4,
                             img_size=64)
    conf = yolo_train_conf(parse_string, "false")
    dset, val_dset, _ = get_split_dataset("yolo", root, conf=conf)
    model = make_model(conf.get_config("model"), device="cpu", seed=0)
    trainer = make_trainer(train_args(tmp_path, "spans"), conf, dset,
                           val_dset, model, make_renderer(conf, device="cpu"),
                           [3], device="cpu")
    batch = next(iter(DataLoader(dset, batch_size=1)))
    with profiling.recording():
        trainer.train_step(batch)
        recs = profiling.records()
    roots = [r for r in recs if r.parent < 0]
    assert [r.name for r in roots] == ["train_step"]
    children = {r.name for r in recs if r.parent == roots[0].index}
    assert {"batch_assemble", "yolo_loss", "optimizer", "encode",
            "yolo_render"} <= children
    assert all(r.root == roots[0].index for r in recs)
    # a train_step root open around the backward leaves its FLOPs to
    # (backward), and no span of the port names a stage
    stages = by_stage(count_flops(trainer.train_step, batch)[1])
    assert stages[profiling.BACKWARD] > 0
    assert not set(stages) & set(PORT_SPANS)


def test_drops_past_the_bound(monkeypatch):
    from benchmark import program_spans

    monkeypatch.setattr(profiling, "MAX_RECORDS", 3)
    with profiling.recording():
        with scope("train_step"):
            for _ in range(4):
                with scope("yolo_loss"):
                    pass
        assert len(profiling.records()) == 3 and profiling.dropped() == 2
        sl = type("Slice", (), {"units": 1})()
        assert program_spans.span_ms(sl, "yolo_loss") is None
        assert program_spans.syncs(sl) is None
    with profiling.recording():
        with scope("yolo_loss"):
            pass
        assert profiling.dropped() == 0
        assert program_spans.span_ms(sl, "yolo_loss") > 0
        assert program_spans.syncs(sl) == 0


def test_syncs_count_against_the_innermost_span():
    shown = []
    previous = warnings.showwarning

    def ours(message, *args, **kwargs):
        shown.append(str(message))

    warnings.showwarning = ours
    try:
        with profiling.recording():
            with scope("nms_padded"):
                with scope("decode_cells"):
                    for _ in range(2):
                        warnings.warn(SYNC)
                warnings.warn(SYNC)
                warnings.warn("another warning")
            warnings.warn(SYNC)
            counts = profiling.counters()
        assert counts == {"syncs:decode_cells": 2, "syncs:nms_padded": 1}
        assert shown == ["another warning"]
        # recording off: the hook is gone and nothing counts
        with scope("nms_padded"):
            profiling.count_sync()
        assert warnings.showwarning is ours
        assert profiling.counters() == counts
    finally:
        warnings.showwarning = previous
