"""The latent lookup's route (ops/grid_sample.py::grid_sample_nhwc): which
lookups take the gather kernel (csrc/latent_gather.cu) and which keep the
plain chain (``_corners`` + ``_combine``), the points each path counts, and
the benchmark's readers of those counts (``latent_kernel_share.*``).

The kernel runs only on a card, where tests/test_torch_kernels.py holds it
to the chain bitwise.  Here the launcher is stubbed by one that records its
calls and returns the chain's result, and a CPU tensor that reads as a
card's (``_card``) stands for the card's where a test needs its route."""

import json
from pathlib import Path

import pytest
import torch

from pixelnerf_yolo_torch.ops import grid_sample as gs
from pixelnerf_yolo_torch.ops import latent_gather as lg
from pixelnerf_yolo_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
DTYPES = (torch.bfloat16, torch.float16, torch.float32)
PADS = [(p, a) for p in ("zeros", "border", "reflection") for a in (True,
                                                                      False)]
H, W = 5, 6


class _CardTensor(torch.Tensor):
    """A CPU tensor whose ``is_cuda`` reads True; what is computed from it
    is a plain tensor."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    @property
    def is_cuda(self):
        return True


def _card(t):
    return t.as_subclass(_CardTensor)


def _inputs(dtype=torch.bfloat16, B=2, C=8, N=37, seed=0):
    g = torch.Generator().manual_seed(seed)
    flat = torch.randn((B, H * W, C), generator=g).to(dtype)
    grid = torch.rand((B, N, 2), generator=g) * 2.4 - 1.2
    return flat, grid


def _chain(flat, grid, padding="zeros", align=True):
    return gs._combine(flat, gs._corners(grid, H, W, padding, align),
                       flat.dtype)


def _lookup(flat, grid, padding="zeros", align=True, **kw):
    return gs.grid_sample_nhwc(flat, grid, H, W, padding_mode=padding,
                               align_corners=align, **kw)


@pytest.fixture
def calls(monkeypatch):
    """The launcher replaced by one that records its arguments and returns
    the chain's result."""
    seen = []

    def launch(flat, grid, height, width, padding_mode="zeros",
               align_corners=False):
        seen.append((flat, grid, height, width, padding_mode, align_corners))
        return gs._combine(flat, gs._corners(grid, height, width,
                                             padding_mode, align_corners),
                           flat.dtype)

    monkeypatch.setattr(lg, "latent_gather", launch)
    return seen


@pytest.mark.parametrize("padding,align", PADS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_tensors_take_the_chain(calls, dtype, padding, align):
    flat, grid = _inputs(dtype)
    with torch.no_grad():
        got = _lookup(flat, grid, padding, align)
    assert calls == []
    assert torch.equal(got, _chain(flat, grid, padding, align))


@pytest.mark.parametrize("padding,align", PADS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_card_lookup_without_gradient_takes_the_kernel(calls, dtype,
                                                       padding, align):
    flat, grid = _inputs(dtype)
    flat = _card(flat)
    with torch.no_grad():
        got = _lookup(flat, grid, padding, align)
    assert len(calls) == 1
    f, g, h, w, p, a = calls[0]
    assert f is flat and g is grid and (h, w, p, a) == (H, W, padding, align)
    assert torch.equal(got, _chain(flat, grid, padding, align))
    # grad mode on, but nothing that records a gradient: the kernel too
    _lookup(flat, grid, padding, align)
    assert len(calls) == 2


def test_kernel_gets_contiguous_operands(calls):
    flat, grid = _inputs(C=8)
    flat_t = _card(flat.transpose(1, 2).contiguous().transpose(1, 2))
    grid_t = grid.transpose(0, 1).contiguous().transpose(0, 1)
    with torch.no_grad():
        got = _lookup(flat_t, grid_t)
    f, g = calls[0][:2]
    assert f.is_contiguous() and g.is_contiguous()
    assert torch.equal(got, _chain(flat, grid))


@pytest.mark.parametrize("which", ("table", "grid", "both"))
@pytest.mark.parametrize("dtype", DTYPES)
def test_recorded_gradient_keeps_the_chain(calls, dtype, which):
    """A lookup that records a gradient takes the autograd chain (the bf16
    and f16 table's f32-summed scatter-add backward), and its gradients are
    the chain's own."""
    flat, grid = _inputs(dtype)
    grads = []
    for route in (_lookup, _chain):
        f = _card(flat.clone()).requires_grad_(which in ("table", "both"))
        g = grid.clone().requires_grad_(which in ("grid", "both"))
        route(f, g).float().square().sum().backward()
        grads.append([t.grad for t in (f, g) if t.requires_grad])
    assert calls == []
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("form", ("interp_matmul", "nearest", "q8", "float64",
                                  "f16_grid"))
def test_other_forms_never_reach_the_kernel(calls, form):
    flat, grid = _inputs(torch.bfloat16)
    flat = _card(flat)
    with torch.no_grad():
        if form == "interp_matmul":
            _lookup(flat, grid, interp_matmul=True)
        elif form == "nearest":
            _lookup(flat, grid, mode="nearest")
        elif form == "q8":
            q, scales = gs.quantize_rows_int8(flat)
            gs.grid_sample_nhwc_q8(q, scales, grid, H, W)
        elif form == "float64":
            _lookup(_card(flat.double()), grid)
        else:
            _lookup(flat, grid.half())
    assert calls == []


def _counted(fn):
    """The lookup counters after fn runs inside a recorded span."""
    with profiling.recording():
        with profiling.scope("encoder_index"):
            fn()
    counts = profiling.counters()
    return (counts.get("latent_kernel_points", 0),
            counts.get("latent_plain_points", 0))


@pytest.mark.parametrize("B,N", ((1, 37), (3, 5)))
def test_counters_follow_the_route(calls, B, N):
    flat, grid = _inputs(B=B, N=N)
    # the CPU's lookups are not the card's: neither counter
    assert _counted(lambda: _lookup(flat, grid)) == (0, 0)
    flat = _card(flat)
    with torch.no_grad():
        assert _counted(lambda: _lookup(flat, grid)) == (B * N, 0)
    table = _card(flat.clone()).requires_grad_(True)
    assert _counted(lambda: _lookup(table, grid)) == (0, B * N)
    with torch.no_grad():
        assert _counted(lambda: _lookup(flat, grid, mode="nearest")) == (
            0, B * N)


def _reader(unit):
    from benchmark.harness import load_module

    return load_module(ROOT / "benchmark" / "metrics"
                       / f"latent_kernel_share.{unit}.py").read


@pytest.mark.parametrize("unit", ("render", "detect", "train"))
def test_share_readers(calls, unit):
    read = _reader(unit)
    sl = type("Slice", (), {"units": 4})()
    flat, grid = _inputs(B=2, N=10)
    table = _card(flat.clone()).requires_grad_(True)
    flat = _card(flat)

    def kernel():
        with torch.no_grad():
            _lookup(flat, grid)

    def plain():
        _lookup(table, grid)

    _counted(kernel)
    assert read(sl) == 100.0
    _counted(plain)
    assert read(sl) == 0.0
    _counted(lambda: (kernel(), plain(), plain(), plain()))
    assert read(sl) == 25.0
    _counted(lambda: None)  # a span, and no lookup (the parent program)
    assert read(sl) is None
    with profiling.recording():  # no span at all
        kernel()
    assert read(sl) is None


def test_share_metrics_in_the_benchmark():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for unit, moves, cells in (
            ("render", "rays_per_s", ["srn_views"]),
            ("detect", "view_p95_ms", ["yolo_detect", "yolo3s_detect"]),
            ("train", "train_steps_per_s", ["yolo_train", "srn_train"])):
        m = per_layer[f"latent_kernel_share.{unit}"]
        assert (m["source"], m["layer"], m["moves"], m["workloads"],
                m["unit"]) == ("program_counter", "latent lookup", moves,
                               cells, "%")
        assert per_layer[f"gather_ms.{unit}"]["layer"] == m["layer"]


def test_latent_gather_op_on_the_cpu_is_the_chain():
    """The custom op (what an exported render records) runs the chain on
    CPU tensors; its fake kernel gives the output's shape."""
    flat, grid = _inputs(torch.float16, B=3, C=5, N=11)
    got = torch.ops.pixelnerf_yolo.latent_gather(flat, grid, H, W,
                                                 "reflection", False)
    assert torch.equal(got, _chain(flat, grid, "reflection", False))
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        out = torch.ops.pixelnerf_yolo.latent_gather(
            mode.from_tensor(flat), mode.from_tensor(grid), H, W, "zeros",
            True)
    assert out.shape == (3, 11, 5) and out.dtype == torch.float16


@pytest.mark.parametrize("bad", ("device", "padding"))
def test_wrapper_checks(bad):
    flat, grid = _inputs()
    with pytest.raises(NotImplementedError if bad == "padding"
                       else ValueError):
        lg._check(flat, grid, H, W, "wrap" if bad == "padding" else "zeros")
