"""Profiler cut points and spans, the port's counters, and the FLOP count
by stage.

The JAX package marks its hot path with ``jax.named_scope`` cut points
that mirror the reference's ``record_function`` scopes
(``scripts/profile_trace.py``).  The port marks the same sites with
``scope(name)``, and its own layer boundaries (``PORT_SPANS``: detection,
the train step's host work, the YOLO render's parts) the same way.  A
scope always enters a thread-local stack of the names open, which
``count_flops`` reads to put each op's FLOPs in the innermost of the JAX
cut points.

While recording is on (a ``torch.profiler`` session runs, or inside
``recording()``) a scope also enters a ``torch.profiler.record_function``
range, which a trace records as a ``user_annotation`` event
(``pixelnerf_yolo_torch.profile_trace`` reduces such a trace to a stage
table), and appends a span to the in-memory recorder: its name, start and
end on the profiler's clock (Unix ns, which is the exported trace's
``ts`` plus its ``baseTimeNanoseconds``), read just inside the range so
that its event holds the span, and the indices of its parent and its
root span.  ``count(name, n)`` adds to a counter then, and every
host-device sync the program makes (``.item()``, ``bool()``, indexing by a
0-dim device tensor, a pageable or blocking copy between host and device)
counts as ``syncs:<span>`` against the innermost open scope; a sync with
no scope open is not counted.  Syncs are seen through
``torch.cuda.set_sync_debug_mode("warn")``, switched on while recording
is, whose warnings a hook in place of ``warnings._showwarnmsg`` counts
and swallows.  While recording is off a
scope costs a flag check and the stack.  A new profiler session starts
an empty recorder; ``records()``, ``counters()`` and ``dropped()`` read
the latest one after it ends.

Under ``torch.compile`` or ``torch.export`` tracing the scopes are left
out: an exported program carries no profiler ops.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import re
import threading
import time
import warnings

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry, register_flop_formula

# the JAX package's cut points (scripts/profile_trace.py's KNOWN_SCOPES),
# in its order; the innermost of them around an op names its stage
KNOWN_SCOPES = (
    "encoder_index_pre",
    "encoder_index",
    "positional_enc",
    "resblock",
    "resnetfc_infer",
    "model_inference",
    "renderer_composite",
    "renderer_forward",
    "encoder_trunk",
    "optimizer",
)
# the port's own spans, recorded and counted like the cut points but
# outside count_flops' stages
PORT_SPANS = (
    "train_step",
    "batch_assemble",
    "encode",
    "yolo_render",
    "yolo_aggregate",
    "yolo_loss",
    "nerf_loss",
    "decode_cells",
    "nms_padded",
    "cross_scale_padded",
)
_KNOWN = frozenset(KNOWN_SCOPES)
# the stages of ops outside every cut point: on an autograd thread (or
# while autograd runs a node on this one) and elsewhere
BACKWARD, NO_SCOPE = "(backward)", "(no scope)"
# spans a session keeps; past it they are counted as dropped
MAX_RECORDS = 1 << 16
# the warning of torch.cuda.set_sync_debug_mode("warn")
SYNC_WARNING = "called a synchronizing CUDA operation"


@dataclasses.dataclass(slots=True)
class Span:
    """One recorded scope: start and end in Unix ns (end 0 while open);
    index, parent and root are positions in ``records()`` (parent -1: a
    root)."""

    name: str
    start: int
    end: int
    index: int
    parent: int
    root: int


class _Stack(threading.local):
    def __init__(self):
        self.names: list[str] = []
        self.spans: list = []  # each open scope's Span, or None


_stack = _Stack()


class _Recorder:
    """The spans and counters of the latest recording session, and the
    sync hook's state while one runs."""

    def __init__(self):
        self.lock = threading.RLock()
        self.spans: list[Span] = []
        self.dropped = 0
        self.counters: collections.Counter = collections.Counter()
        self.forced = 0  # depth of recording() blocks
        self.active = False  # recording at the latest look
        self.restore = None  # undoes the sync hook

    def clear(self):
        with self.lock:
            self.spans, self.dropped = [], 0
            self.counters = collections.Counter()

    def open(self, name: str, parent, start: int) -> Span | None:
        """A new span under parent (a Span of this session, else a root),
        or None past ``MAX_RECORDS``."""
        with self.lock:
            i = len(self.spans)
            if i >= MAX_RECORDS:
                self.dropped += 1
                return None
            if (parent is None or parent.index >= i
                    or self.spans[parent.index] is not parent):
                parent = None
            span = Span(name, start, 0, i,
                        -1 if parent is None else parent.index,
                        i if parent is None else parent.root)
            self.spans.append(span)
            return span

    def switch(self, on: bool):
        """Recording turned on (a new session unless recording() turned it
        on inside one) or off: the sync hook with it."""
        with self.lock:
            if on == self.active:
                return
            self.active = on
            if self.restore is not None:
                self.restore()
                self.restore = None
            if on:
                self.restore = _hook_syncs()
                if not self.forced:
                    self.clear()


_rec = _Recorder()


def _on() -> bool:
    on = _rec.forced > 0 or torch.autograd._profiler_enabled()
    if on != _rec.active:
        _rec.switch(on)
    return on


def _hook_syncs():
    """Warn on every sync (once CUDA is up) and count each warning; ->
    the function that undoes it."""
    mode = None
    if torch.cuda.is_initialized():
        mode = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # "a prototype feature"
            torch.cuda.set_sync_debug_mode("warn")
    # shown every time, past the once-a-site registry of the default action
    item = ("always", re.compile(re.escape(SYNC_WARNING)), UserWarning,
            None, 0)
    warnings.filters.insert(0, item)
    warnings._filters_mutated()
    # the warnings module's one call per warning shown ("replace if you
    # like"), one Python frame short of showwarning
    shown = warnings._showwarnmsg

    def hook(msg):
        if msg.category is UserWarning and str(msg.message).startswith(
                SYNC_WARNING):
            count_sync()
        else:
            shown(msg)

    warnings._showwarnmsg = hook

    def restore():
        if mode is not None:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                torch.cuda.set_sync_debug_mode(mode)
        if item in warnings.filters:
            warnings.filters.remove(item)
            warnings._filters_mutated()
        if warnings._showwarnmsg is hook:
            warnings._showwarnmsg = shown

    return restore


class scope:
    """A named cut point or span: an entry of this thread's scope stack
    while the block runs and, while recording is on, a ``record_function``
    range and a recorded span."""

    __slots__ = ("name", "_range", "_span", "_entered")

    def __init__(self, name: str):
        self.name = name
        self._range = self._span = None
        self._entered = False

    def __enter__(self):
        if torch.compiler.is_compiling():
            return self
        st = _stack
        if _on():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
            # the clock read just inside the range: its event holds the span
            self._span = _rec.open(self.name,
                                   st.spans[-1] if st.spans else None,
                                   time.time_ns())
        st.names.append(self.name)
        st.spans.append(self._span)
        self._entered = True
        return self

    def __exit__(self, *exc):
        if not self._entered:
            return False
        st = _stack
        st.names.pop()
        st.spans.pop()
        if self._span is not None:
            self._span.end = time.time_ns()
            self._span = None
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self._entered = False
        return False


@contextlib.contextmanager
def recording():
    """Record spans and counters while the block runs, as under a
    ``torch.profiler`` session; entered while recording is off, it starts
    an empty recorder."""
    fresh = not _on()
    _rec.forced += 1
    if fresh:
        _rec.clear()
    _on()
    try:
        yield
    finally:
        _rec.forced -= 1
        _on()


def reset():
    """Empty the recorder: its spans, drops and counters."""
    _rec.clear()


def records() -> list:
    """The latest session's spans (``Span``), in the order they opened."""
    _on()
    with _rec.lock:
        return list(_rec.spans)


def counters() -> dict:
    """The latest session's counters."""
    _on()
    with _rec.lock:
        return dict(_rec.counters)


def dropped() -> int:
    """Spans of the latest session past ``MAX_RECORDS``, not kept."""
    return _rec.dropped


def count(name: str, n: int = 1):
    """Add n to counter name while recording is on."""
    if _on():
        with _rec.lock:
            _rec.counters[name] += n


def count_sync():
    """One host-device sync of this thread: counted as ``syncs:<span>``
    against the innermost open scope, not counted with none open."""
    if _stack.names:
        count("syncs:" + _stack.names[-1])


def current_stage() -> str:
    """The innermost JAX cut point this thread is in, else ``(backward)``
    while autograd runs a node, else ``(no scope)``."""
    for name in reversed(_stack.names):
        if name in _KNOWN:
            return name
    if torch._C._current_autograd_node() is not None:
        return BACKWARD
    return NO_SCOPE


class _StageFlops(TorchDispatchMode):
    """``FlopCounterMode``'s dispatch rule (decompose what has no formula,
    count what has one) with each count keyed by (stage, op)."""

    def __init__(self, counts):
        super().__init__()
        self.counts = counts

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return NotImplemented
        packet = func._overloadpacket
        if packet not in flop_registry and func is not torch.ops.prim.device.default:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        formula = flop_registry.get(packet)
        if formula is not None:
            self.counts[(current_stage(), str(packet))] += int(
                formula(*args, **kwargs, out_val=out))
        return out


def _int_mm_flops(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    """``torch._int_mm`` (``model.mlp_int8``'s int8 products): 2 m n k, as
    ``mm``; ``torch.utils.flop_counter`` has no formula for it."""
    return 2 * a_shape[0] * a_shape[1] * b_shape[1]


if torch.ops.aten._int_mm not in flop_registry:
    register_flop_formula(torch.ops.aten._int_mm)(_int_mm_flops)


def count_flops(fn, *args, **kwargs):
    """Run fn(*args, **kwargs) and count its FLOPs with
    ``torch.utils.flop_counter``'s formulas (products and convolutions;
    elementwise ops count 0, as in ``FlopCounterMode``; the field-MLP
    kernel ops count their plain twins' products): (fn's result, a Counter
    of FLOPs by (stage, op name)), the stage as ``current_stage``.  The
    backward of a ``.backward()`` inside fn counts too."""
    counts: collections.Counter = collections.Counter()
    with _StageFlops(counts):
        out = fn(*args, **kwargs)
    return out, counts


def by_stage(counts) -> dict:
    """{stage: FLOPs} of a ``count_flops`` Counter."""
    out: collections.Counter = collections.Counter()
    for (stage, _), n in counts.items():
        out[stage] += n
    return dict(out)
