"""Arithmetic the per-layer metric readers (``metrics/*.py``) share."""

from __future__ import annotations

from . import flops

GATHER = ("encoder_index", "encoder_index_pre")
FIELD = ("model_inference", "resnetfc_infer", "resblock", "positional_enc")


def stage_ms(sl, names, backward=False) -> float | None:
    """ms a unit of work in the stages names (with backward, their
    ``bwd:`` stages too); None where the slice has none of them."""
    keys = set(names) | ({"bwd:" + n for n in names} if backward else set())
    hit = [v for k, v in sl.red.stages.items() if k in keys]
    return sum(hit) * 1e3 / sl.units if hit else None


def backward_ms(sl) -> float | None:
    hit = [v for k, v in sl.red.stages.items() if k.startswith("bwd:")]
    return sum(hit) * 1e3 / sl.units if hit else None


def mfu(sl) -> float:
    """% of the card's dense peak in the configuration's dtype: the
    reference algorithm's FLOPs of the slice's units over its seconds."""
    work = sl.driver.per_unit()["flops"] * sl.units
    return 100.0 * work / sl.red.window_s / flops.PEAK_FLOPS[sl.dtype]


def idle_share(sl) -> float:
    return 100.0 * sl.red.idle_share


def roofline(sl, ops) -> float | None:
    """% of the least time the launches of ops could take (each launch's
    FLOPs at the peak or its bytes at the HBM rate, whichever is longer)
    in their device time; None without a launch."""
    w = flops.field_widths(sl.driver.cfg["conf"])
    size = 2 if sl.dtype == "bfloat16" else 4
    least = spent = 0.0
    for op, rows, sec in sl.red.kernel_launches:
        if op in ops and sec > 0:
            f, b = flops.kernel_work(op, rows, w, size)
            least += flops.roofline_seconds(f, b, sl.dtype)[0]
            spent += sec
    return 100.0 * least / spent if spent else None
