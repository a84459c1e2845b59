"""``assemble_rays.train``, the rays the NeRF trainer's batch assembly
builds a step: None with no recorder, and where the counter is 0 or
absent (a program that builds no such count, or the YOLO trainer); in a
traced ``srn_train`` run at test size, the step's drawn rays."""

import time

import pytest

from benchmark import harness, program_spans
from test_harness_new_cells import tiny_cell

SLICE = type("Slice", (), {"units": 2})()


def read(sl):
    return harness.load_module(harness.ROOT / "benchmark" / "metrics"
                               / "assemble_rays.train.py").read(sl)


def test_none_without_the_recorder(monkeypatch):
    from pixelnerf_yolo_torch.utils import profiling

    monkeypatch.delattr(profiling, "records")
    assert program_spans.recorder() is None
    assert read(SLICE) is None


@pytest.mark.parametrize("counted,want", [(None, None), (0, None),
                                          (1024, 512)])
def test_reads_the_counter(counted, want):
    from pixelnerf_yolo_torch.utils import profiling

    with profiling.recording():
        with profiling.scope("batch_assemble"):
            if counted is not None:
                profiling.count("assemble_rays", counted)
        assert read(SLICE) == want


def test_traced_srn_train_reads_the_drawn_rays():
    cell = tiny_cell("srn_train")
    res = harness.execute(cell, 2 ** 33 + 43, 0.3, True, "cpu",
                          time.perf_counter())
    assert res["correct"]
    tr = cell.traffic
    assert res["metrics"]["assemble_rays.train"]["value"] == \
        tr["sb"] * tr["rays_per_object"]
