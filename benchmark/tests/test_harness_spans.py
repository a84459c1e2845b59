"""The per-layer metrics that read the program's own spans and counters
(``program_spans.py``): each reads a number in a traced run at test size
on the CPU (the syncs 0: the CPU makes none), and nothing from a program
without the recorder."""

import time

import pytest

from conftest import tiny_cell

NEW = {"yolo_detect": ("nms_ms.detect", "nms_rounds.detect", "syncs.detect"),
       "yolo_train": ("assemble_ms.train", "syncs.train"),
       "srn_views": ("syncs.render",)}


@pytest.mark.parametrize("name", sorted(NEW))
def test_new_metrics_read_a_number(name):
    from benchmark import harness

    res = harness.execute(tiny_cell(name), 2 ** 33 + 29, 0.3, True, "cpu",
                          time.perf_counter())
    assert res["correct"]
    got = {k: v["value"] for k, v in res["metrics"].items() if k in NEW[name]}
    assert set(got) == set(NEW[name])
    for metric, value in got.items():
        if metric.startswith("syncs."):
            assert value == 0
        elif metric.startswith("nms_rounds"):
            assert value in (0, 32)  # one traced request
        else:
            assert value > 0


def test_nothing_to_read_without_the_recorder(monkeypatch):
    from benchmark import program_spans
    from pixelnerf_yolo_torch.utils import profiling

    sl = type("Slice", (), {"units": 2})()
    monkeypatch.delattr(profiling, "records")
    assert program_spans.span_ms(sl, "nms_padded") is None
    assert program_spans.counter(sl, "nms_rounds") is None
    assert program_spans.syncs(sl) is None
