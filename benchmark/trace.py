"""Reduction of a ``torch.profiler`` Chrome trace to stage times, busy
and idle time, the field kernels' launches with their rows, and the
longest idle gaps by what the host was doing.

A frozen copy of the attribution arithmetic of the program's
``profile_trace.py``: each GPU kernel (memcpy, memset) goes through its
correlation id to the runtime call that launched it, and from there to
the innermost of the program's cut-point ranges open around that call on
its thread; a launch on an autograd thread outside every range goes to
the range of the forward op that made its graph node (the sequence
number they share), as ``bwd:<scope>``; anything else to ``(no
scope)``."""

from __future__ import annotations

import collections
import dataclasses

# the program's cut points (``record_function`` ranges), innermost wins
KNOWN_SCOPES = ("encoder_index_pre", "encoder_index", "positional_enc",
                "resblock", "resnetfc_infer", "model_inference",
                "renderer_composite", "renderer_forward", "encoder_trunk",
                "optimizer")
NO_SCOPE = "(no scope)"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
BACKWARD_OP = "autograd::engine::evaluate_function"
# the program's field-kernel ops (custom ops ``pixelnerf_yolo::<mode>``)
KERNEL_OP_PREFIX = "pixelnerf_yolo::"


def _span(e):
    return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))


def _innermost(intervals, queries):
    """For each (key, ts) query, the payload of the innermost interval
    (start, end, payload) of intervals[key] containing ts, or None.
    Intervals of one key nest (ranges of one thread)."""
    out = [None] * len(queries)
    by_key = collections.defaultdict(list)
    for i, (key, _) in enumerate(queries):
        if key is not None:
            by_key[key].append(i)
    for key, idx in by_key.items():
        idx.sort(key=lambda i: queries[i][1])
        ivs = sorted(intervals.get(key, ()), key=lambda v: (v[0], -v[1]))
        stack, j = [], 0
        for i in idx:
            ts = queries[i][1]
            while j < len(ivs) and ivs[j][0] <= ts:
                while stack and stack[-1][1] < ivs[j][0]:
                    stack.pop()
                stack.append(ivs[j])
                j += 1
            while stack and stack[-1][1] < ts:
                stack.pop()
            out[i] = stack[-1][2] if stack else None
    return out


def union_spans(spans):
    """The union of (start, end) spans as sorted disjoint spans."""
    out = []
    for s, t in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


@dataclasses.dataclass
class Reduction:
    stages: dict  # stage -> device seconds
    ops: dict  # device op name -> seconds
    busy_s: float
    window_s: float
    kernel_launches: list  # [(op, rows, device seconds)]
    idle_gaps: dict  # innermost host range during the gap -> seconds

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s if self.window_s else 0.0


def reduce(events, window) -> Reduction:
    """window (start, end) in the trace's microseconds: the slice whose
    device work, busy time and idle gaps are counted."""
    w0, w1 = window
    xs = [e for e in events if e.get("ph") == "X"]
    ops = [e for e in xs if e.get("cat") in DEVICE_CATS
           and w0 <= float(e["ts"]) <= w1]
    scopes = collections.defaultdict(list)
    host = collections.defaultdict(list)
    kernel_ops = collections.defaultdict(list)
    bwd = collections.defaultdict(list)
    fwd = {}
    for e in xs:
        cat, name = e.get("cat"), e.get("name", "")
        if cat == "user_annotation" and name in KNOWN_SCOPES:
            scopes[e["tid"]].append((*_span(e), name))
        if cat in ("user_annotation", "cpu_op", "cuda_runtime"):
            host[e["tid"]].append((*_span(e), name))
        if cat == "cpu_op" and name.startswith(KERNEL_OP_PREFIX):
            dims = e.get("args", {}).get("Input Dims") or [[0]]
            kernel_ops[e["tid"]].append(
                (*_span(e), (name[len(KERNEL_OP_PREFIX):], dims[0][0],
                             float(e["ts"]))))
        seq = e.get("args", {}).get("Sequence number")
        if cat == "cpu_op" and seq is not None:
            if name.startswith(BACKWARD_OP):
                bwd[e["tid"]].append((*_span(e), seq))
            elif seq not in fwd or float(e["ts"]) < float(fwd[seq]["ts"]):
                fwd[seq] = e
    launch = {e["args"]["correlation"]: e for e in xs
              if e.get("cat") in LAUNCH_CATS
              and "correlation" in e.get("args", {})}
    points = [launch.get(e.get("args", {}).get("correlation")) for e in ops]
    queries = [(p["tid"], float(p["ts"])) if p is not None else (None, 0.0)
               for p in points]
    stage = _innermost(scopes, queries)
    node = _innermost(bwd, queries)
    back = [fwd.get(k) if k is not None and s is None else None
            for k, s in zip(node, stage)]
    bstage = _innermost(scopes, [(f["tid"], float(f["ts"])) if f is not None
                                 else (None, 0.0) for f in back])
    owner = _innermost(kernel_ops, queries)
    stages = collections.defaultdict(float)
    by_op = collections.defaultdict(float)
    launches = collections.defaultdict(float)
    for e, s, f, b, k in zip(ops, stage, back, bstage, owner):
        sec = float(e.get("dur", 0.0)) / 1e6
        name = s if s is not None else (
            "bwd:" + b if f is not None and b is not None else NO_SCOPE)
        stages[name] += sec
        by_op[e.get("name", "?")] += sec
        if k is not None:
            launches[k] += sec
    busy = union_spans([_span(e) for e in ops])
    gaps = collections.defaultdict(float)
    main_tid = max(host, key=lambda t: sum(b - a for a, b, _ in host[t])) \
        if host else None
    edges = [w0] + [x for s in busy for x in s] + [w1]
    spans = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    labels = _innermost(host, [(main_tid, a) for a, _ in spans])
    for (a, b), label in zip(spans, labels):
        gaps[label or "(no host range)"] += (b - a) / 1e6
    return Reduction(
        dict(stages), dict(by_op), sum(t - s for s, t in busy) / 1e6,
        (w1 - w0) / 1e6,
        [(op, rows, sec) for (op, rows, _), sec in launches.items()],
        dict(gaps))
