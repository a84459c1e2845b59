"""Profiler cut points and the FLOP count by stage.

The JAX package marks its hot path with ``jax.named_scope`` cut points
that mirror the reference's ``record_function`` scopes
(``scripts/profile_trace.py``).  The port marks the same sites with
``scope(name)``: a ``torch.profiler.record_function`` range, which a
``torch.profiler`` trace records as a ``user_annotation`` event around the
ops and kernel launches inside it (``pixelnerf_yolo_torch.profile_trace``
reduces such a trace to a stage table), and a thread-local stack of the
names entered, which ``count_flops`` reads to put each op's FLOPs in the
innermost scope.

Under ``torch.compile`` or ``torch.export`` tracing the scopes are left
out: an exported program carries no profiler ops.
"""

from __future__ import annotations

import collections
import contextlib
import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry, register_flop_formula

# the JAX package's cut points (scripts/profile_trace.py's KNOWN_SCOPES),
# in its order; the innermost scope of an op names its stage
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
# the stages of ops outside every scope: on an autograd thread (or while
# autograd runs a node on this one) and elsewhere
BACKWARD, NO_SCOPE = "(backward)", "(no scope)"


class _Stack(threading.local):
    def __init__(self):
        self.names: list[str] = []


_stack = _Stack()


@contextlib.contextmanager
def scope(name: str):
    """A named cut point: a ``record_function`` range and an entry of this
    thread's scope stack while the block runs."""
    if torch.compiler.is_compiling():
        yield
        return
    with torch.profiler.record_function(name):
        _stack.names.append(name)
        try:
            yield
        finally:
            _stack.names.pop()


def current_stage() -> str:
    """The innermost scope this thread is in, else ``(backward)`` while
    autograd runs a node, else ``(no scope)``."""
    if _stack.names:
        return _stack.names[-1]
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
