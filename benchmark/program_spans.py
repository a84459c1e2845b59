"""Arithmetic the readers of the program's own spans and counters share.

The program keeps its spans and counters in memory while a
``torch.profiler`` session runs (``pixelnerf_yolo_torch/utils/
profiling.py``: ``records()``, ``counters()``, ``dropped()``).  The traced
slice is such a session, so after it the recorder holds what the slice's
units did.  A program without that recorder, or one whose slice dropped
spans past its bound, gives nothing to read: None."""

from __future__ import annotations


def recorder():
    """The program's recorder, or None where it has none or the latest
    session dropped spans."""
    try:
        from pixelnerf_yolo_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "records") or profiling.dropped():
        return None
    return profiling


def span_ms(sl, name: str) -> float | None:
    """Host ms a unit of work in the spans called name, each with its
    children and its sync waits; None where there is none."""
    rec = recorder()
    if rec is None:
        return None
    ns = [r.end - r.start for r in rec.records() if r.name == name and r.end]
    return sum(ns) / 1e6 / sl.units if ns else None


def counter(sl, name: str | None = None, prefix: str | None = None):
    """Counter name (or the sum of the counters whose names start with
    prefix) a unit of work, 0 where it never counted; None where the slice
    recorded no span."""
    rec = recorder()
    if rec is None or not rec.records():
        return None
    counts = rec.counters()
    n = (counts.get(name, 0) if prefix is None else
         sum(v for k, v in counts.items() if k.startswith(prefix)))
    return n / sl.units


def syncs(sl):
    """Host-device syncs a unit of work inside the program's scopes
    (every ``syncs:<span>`` counter)."""
    return counter(sl, prefix="syncs:")
