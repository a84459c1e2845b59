"""Fused field MLP: hand-written Hopper kernels and their plain twins.

Counterpart of pixelnerf_yolo_tpu/ops/pallas/fused_mlp.py.  Four kernels
replace its four Pallas kernels:

  full_pe         <- fused_full_pe         whole ResnetFC, NS == 1
  pre_combine_pe  <- fused_pre_combine_pe  PE + lin_in + pre-combine blocks
  post_combine    <- fused_post_combine    post-combine blocks + lin_out
  pre_combine     <- fused_pre_combine     lin_in on given z-features +
                                           pre-combine blocks

The first three carry models whose positional encoding fits in the kernel
(``fused_pe_forward``); the last carries the others (``fused_forward``,
e.g. ``use_code_viewdirs = True``), followed by ``post_combine``.

Two variants (``variant``), each CUDA C++ for sm_90a: every bf16 mode
runs on the tensor cores (csrc/field_mlp_tc.cu: wgmma, weights streamed
through a ring of TMA copies, packed once by ``pack_tc``); every f32 mode
on the CUDA cores with the weight slices and the latent streamed through
a ring of bulk and TMA copies (csrc/field_mlp_f32.cu, no packing:
``f32_schedule`` mirrors its walk).

Each wrapper runs its plain twin (``*_plain``: the same function with the
same rounding points, in plain torch) when its tensors lie on the CPU,
launches its kernel when they lie on a CUDA device, and raises otherwise.

Training goes through two autograd Functions, ``FusedResnetFC`` and
``FusedResnetFCPE`` (the JAX package's ``custom_vjp``s ``fused_resnetfc``
and ``fused_resnetfc_pe``): the forward runs the kernels on detached
inputs and keeps only the latent, the z-features (or the PE base) and the
parameters; the backward recomputes the plain ResnetFC (nn/resnetfc.py)
on them and returns its gradients.  There is no backward kernel, as there
is none in the JAX package.
``launches`` counts kernel launches per wrapper, ``variant_launches``
per wrapper and variant ("mode/variant").

Rounding points (shared by kernels and twins): each Dense is an f32
accumulation plus an f32 bias, then one cast to the compute dtype; the
residual stream stays in the compute dtype; lin_out takes the compute-dtype
w_out and returns f32.  The libraries are compiled with nvcc at first use
(one nvcc per source, started together) into ``_build/`` beside this
package and bound with ctypes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
import weakref
from pathlib import Path

import torch

from ..nn.code import PositionalEncoding

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCES = {"field_mlp_tc": PACKAGE_DIR / "csrc" / "field_mlp_tc.cu",
           "field_mlp_f32": PACKAGE_DIR / "csrc" / "field_mlp_f32.cu"}
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Mirrors of the kernels' tiling constants (checked against the libraries
# when they load) and the per-block shared-memory limit of sm_90.  Both
# kernels take hidden widths that are multiples of HIDDEN_STEP (the f32
# kernel's 8 warps x 8 column lanes) up to MAX_HIDDEN.
HIDDEN_STEP = 64
MAX_HIDDEN = 512
SMEM_LIMIT = 232448
# the tensor-core variant (field_mlp_tc.cu): rows per CTA, wgmma K step
# (the depth of a ring stage and the packing's slice), ring stages, CTAs
# per cluster, row pad of its activation tiles
TC_ROWS = 64
TC_K_STEP = 16
TC_STAGES = 5
TC_CLUSTER = 2
TC_ROW_PAD = 8
# the f32 ring variant (field_mlp_f32.cu): rows per CTA, depth of a ring
# stage, ring stages, CTAs per cluster, the widest lin_out
F32_ROWS = 32
F32_K_STEP = 16
F32_STAGES = 4
F32_CLUSTER = 2
F32_MAX_OUT = 256
# which library runs each variant
LIBRARY = {"tensor_core": "field_mlp_tc", "cuda_core_ring": "field_mlp_f32"}
MODES = {"full_pe": 0, "pre_combine_pe": 1, "post_combine": 2,
         "pre_combine": 3}
# lin_out widths of the tensor-core kernel (one instantiation each)
TC_OUT_WIDTHS = (8, 16, 24, 32, 64, 128, 256)
launches = {name: 0 for name in MODES}
# the same launches by kernel: "mode/variant" -> count
variant_launches: dict = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
    variant_launches.clear()


@dataclasses.dataclass
class StackedWeights:
    """ResnetFC weights stacked for the kernels: matrices (in, out) in the
    compute dtype, biases f32; pre-combine blocks stacked on dim 0 (the
    lin_z and block 0..CL-1 weights), post-combine blocks likewise.  The
    field order is the argument order of ``field_mlp_launch``."""

    w_in: torch.Tensor
    b_in: torch.Tensor
    wz: torch.Tensor
    bz: torch.Tensor
    w0: torch.Tensor
    b0: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    w0p: torch.Tensor
    b0p: torch.Tensor
    w1p: torch.Tensor
    b1p: torch.Tensor
    w_out: torch.Tensor
    b_out: torch.Tensor
    # the weights packed for the tensor-core variant, made at its first
    # launch (``tc_weights``); not a kernel argument of its own, and not
    # carried over by ``dataclasses.replace``
    tc: torch.Tensor | None = dataclasses.field(default=None, init=False,
                                                repr=False, compare=False)

    @property
    def hidden(self) -> int:
        return self.w_in.shape[1]


# StackedWeights' kernel arguments, in the order of ``field_mlp_launch``
WEIGHT_NAMES = ("w_in", "b_in", "wz", "bz", "w0", "b0", "w1", "b1", "w0p",
                "b0p", "w1p", "b1p", "w_out", "b_out")


def stack_params(mlp, compute_dtype: torch.dtype) -> StackedWeights:
    """Port ResnetFC -> stacked kernel weights (``_stack_params``).  With
    combine_layer >= n_blocks the post-combine stacks are empty (0, ...)."""
    cl = min(mlp.combine_layer, mlp.n_blocks)

    def k(lin):
        return lin.weight.detach().t().to(compute_dtype).contiguous()

    def b(lin):
        return lin.bias.detach().float().contiguous()

    def stack(fn, mods):
        if not len(mods):
            # every block layer is (H, H): block 0's shapes an empty stack
            return fn(mlp.blocks[0].fc_0)[None][:0].contiguous()
        return torch.stack([fn(m) for m in mods]).contiguous()

    pre, post = mlp.blocks[:cl], mlp.blocks[cl:]
    return StackedWeights(
        w_in=k(mlp.lin_in), b_in=b(mlp.lin_in),
        wz=stack(k, mlp.lin_z[:cl]), bz=stack(b, mlp.lin_z[:cl]),
        w0=stack(k, [blk.fc_0 for blk in pre]),
        b0=stack(b, [blk.fc_0 for blk in pre]),
        w1=stack(k, [blk.fc_1 for blk in pre]),
        b1=stack(b, [blk.fc_1 for blk in pre]),
        w0p=stack(k, [blk.fc_0 for blk in post]),
        b0p=stack(b, [blk.fc_0 for blk in post]),
        w1p=stack(k, [blk.fc_1 for blk in post]),
        b1p=stack(b, [blk.fc_1 for blk in post]),
        w_out=k(mlp.lin_out), b_out=b(mlp.lin_out),
    )


def _pack_layer(m: torch.Tensor) -> torch.Tensor:
    """(K, H) with K a multiple of TC_K_STEP -> K / 16 slices, each in
    wgmma's K-major no-swizzle layout: element (16 t + 8 c + e, 8 q + r) of
    slice t at q * 128 + c * 64 + r * 8 + e (8 x 8 core matrices, 128 B
    apart along K and 256 B along N)."""
    K, H = m.shape
    return m.reshape(K // 16, 2, 8, H // 8, 8).permute(0, 3, 1, 4, 2) \
        .reshape(-1)


def tc_out_width(d_out: int) -> int | None:
    """lin_out's width Nout in the tensor-core kernel: d_out rounded up to
    a multiple of 8 up to 32, then to 64, 128 or 256 (8 for NeRF's 4, 24
    for YOLO's 21); None when no width takes d_out."""
    return next((n for n in TC_OUT_WIDTHS if 0 < d_out <= n), None)


def tc_out_stages(hidden: int, nout: int) -> int:
    """Ring stages of lin_out: its hidden / 16 K slices of 16 x nout,
    hidden // nout to a stage (1 for NeRF, 2 for YOLO at hidden 512)."""
    return -(-(hidden // TC_K_STEP) // (hidden // nout))


def _pack_out(w_out: torch.Tensor, nout: int) -> torch.Tensor:
    """(H, d_out) -> whole ring stages: w_out zero-padded to nout columns,
    cut in 16-deep K slices (``_pack_layer``'s layout); slice j sits in
    stage j // (H // nout) at (j % (H // nout)) * 16 * nout, and the rest
    of each stage is zeros."""
    H, d_out = w_out.shape
    per = H // nout
    n_stages = tc_out_stages(H, nout)
    m = w_out.new_zeros((H, nout))
    m[:, :d_out] = w_out
    slices = w_out.new_zeros((n_stages * per, TC_K_STEP * nout))
    slices[:H // TC_K_STEP] = _pack_layer(m).reshape(H // TC_K_STEP, -1)
    stages = w_out.new_zeros((n_stages, TC_K_STEP * H))
    stages[:, :per * TC_K_STEP * nout] = slices.reshape(n_stages, -1)
    return stages.reshape(-1)


def _pad_rows(m: torch.Tensor) -> torch.Tensor:
    """(K, H) -> (K rounded up to the K step, H), zero rows appended."""
    k = m.shape[0]
    return torch.cat([m, m.new_zeros((-k % TC_K_STEP, m.shape[1]))])


def tc_stages(w: StackedWeights) -> tuple[int, int, int]:
    """Ring stages of ``pack_tc(w)``'s three parts: lin_in and the
    pre-combine blocks, the post-combine blocks, lin_out (0 when the
    tensor-core kernel takes no lin_out of this width)."""
    H, k = w.hidden, TC_K_STEP
    pre = (-(-w.w_in.shape[0] // k)
           + w.wz.shape[0] * (-(-w.wz.shape[1] // k) + 2 * H // k))
    nout = tc_out_width(w.w_out.shape[1])
    out = tc_out_stages(H, nout) if nout is not None and nout <= H else 0
    return pre, w.w0p.shape[0] * 2 * H // k, out


def pack_tc(w: StackedWeights) -> torch.Tensor:
    """The weights as one flat stream of 16-deep K slices in the order the
    tensor-core kernel consumes them: lin_in and per pre block lin_z (rows
    zero-padded to a multiple of 16), fc_0, fc_1; per post block fc_0,
    fc_1; lin_out (``_pack_out``, when ``tc_stages`` gives it stages).  A
    ring stage is 16 * H elements; post_combine starts at stage
    ``tc_stages(w)[0]``."""
    parts = [_pack_layer(_pad_rows(w.w_in))]
    for i in range(w.wz.shape[0]):
        parts += [_pack_layer(_pad_rows(w.wz[i])), _pack_layer(w.w0[i]),
                  _pack_layer(w.w1[i])]
    for i in range(w.w0p.shape[0]):
        parts += [_pack_layer(w.w0p[i]), _pack_layer(w.w1p[i])]
    if tc_stages(w)[2]:
        parts.append(_pack_out(w.w_out, tc_out_width(w.w_out.shape[1])))
    return torch.cat(parts).contiguous()


def tc_weights(w: StackedWeights) -> torch.Tensor:
    """``pack_tc(w)``, made once per StackedWeights (and so, through
    ``stacked_params``, once per ResnetFC until its weights change)."""
    if w.tc is None:
        w.tc = pack_tc(w)
    return w.tc


_stacked = weakref.WeakKeyDictionary()


def stacked_params(mlp, compute_dtype: torch.dtype) -> StackedWeights:
    """``stack_params``, kept per ResnetFC until one of its parameters
    changes: in place (its version counter moves) or by a move or a load
    into new storage (its data pointer moves)."""
    key = (compute_dtype,
           tuple((p.data_ptr(), p._version) for p in mlp.parameters()))
    hit = _stacked.get(mlp)
    if hit is None or hit[0] != key:
        hit = (key, stack_params(mlp, compute_dtype))
        _stacked[mlp] = hit
    return hit[1]


# -- plain twins -------------------------------------------------------------


def _dense(a, w, b, cdt):
    return (a.float() @ w.float() + b).to(cdt)


def pe_features(base: torch.Tensor, code: PositionalEncoding) -> torch.Tensor:
    """(N, 6) [xyz, viewdirs] -> (N, d_in) f32 [PE(xyz), viewdirs]."""
    return torch.cat([code(base[:, :3]), base[:, 3:]], dim=-1)


def _pre(zfeat, latent, w: StackedWeights):
    cdt = latent.dtype
    x = _dense(zfeat.to(cdt), w.w_in, w.b_in, cdt)
    for i in range(w.wz.shape[0]):
        x = x + _dense(latent, w.wz[i], w.bz[i], cdt)
        net = _dense(torch.relu(x), w.w0[i], w.b0[i], cdt)
        x = x + _dense(torch.relu(net), w.w1[i], w.b1[i], cdt)
    return x


def _post(x, w: StackedWeights):
    cdt = x.dtype
    for i in range(w.w0p.shape[0]):
        net = _dense(torch.relu(x), w.w0p[i], w.b0p[i], cdt)
        x = x + _dense(torch.relu(net), w.w1p[i], w.b1p[i], cdt)
    return torch.relu(x).float() @ w.w_out.float() + w.b_out


def full_pe_plain(base, latent, w: StackedWeights, code) -> torch.Tensor:
    return _post(pre_combine_pe_plain(base, latent, w, code), w)


def pre_combine_pe_plain(base, latent, w: StackedWeights, code) -> torch.Tensor:
    return _pre(pe_features(base, code), latent, w)


def pre_combine_plain(zfeat, latent, w: StackedWeights) -> torch.Tensor:
    return _pre(zfeat, latent, w)


def post_combine_plain(h, w: StackedWeights) -> torch.Tensor:
    return _post(h, w)


# -- the kernels -------------------------------------------------------------


def variant(mode: str, compute_dtype) -> str:
    """Which kernel a launch of ``mode`` takes: "tensor_core"
    (field_mlp_tc.cu) in bf16, "cuda_core_ring" (field_mlp_f32.cu) in
    f32."""
    return "tensor_core" if compute_dtype == torch.bfloat16 \
        else "cuda_core_ring"


def smem_bytes_f32(hidden: int, k_step: int = F32_K_STEP,
                   stages: int = F32_STAGES) -> int:
    """Shared memory of the f32 ring kernel: alignment slack, the ring
    (k_step x H weight slice + 32 x k_step latent slice per stage, f32),
    the k-major activation buffer (H x 32), the barriers.  It does not grow
    with d_latent."""
    stage = (k_step * hidden + F32_ROWS * k_step) * 4
    return 128 + stages * stage + hidden * F32_ROWS * 4 + 16 * stages


def f32_out_rows(hidden: int, d_out: int, k_step: int = F32_K_STEP) -> int:
    """Rows of w_out (hidden, d_out) that a lin_out stage of the f32 ring
    kernel carries: the fewest stages of at most a slot's k_step x hidden
    floats and a multiple of 8 rows (16-byte pieces for each CTA of a
    cluster), balanced; the last stage takes what is left.  512 rows (one
    stage) at NeRF's d_out 4, 256 (two) at YOLO's 21."""
    fit = k_step * hidden // d_out // 8 * 8  # the most rows a slot holds
    stages = -(-hidden // fit)
    return (-(-hidden // stages) + 7) // 8 * 8


def f32_schedule(d_in: int, d_latent: int, hidden: int, n_pre: int,
                 n_post: int = 0, d_out: int = 0,
                 k_step: int = F32_K_STEP):
    """The ring stages the f32 ring kernel walks, in order, as (weight,
    block, first row, rows, latent column): lin_in's slices of w_in (the
    last one short when d_in is not a multiple of k_step), then per pre
    block lin_z's slices of wz[block] (each with the latent's k_step
    columns from the given one), fc_0's of w0[block] and fc_1's of
    w1[block]; per post block fc_0's of w0p[block] and fc_1's of
    w1p[block]; with d_out > 0 lin_out's slices of w_out
    (``f32_out_rows``).  Each slice is rows [first, first + rows) of its
    (K, N) matrix; latent column None: no latent.  full_pe walks it all,
    pre_combine_pe and pre_combine with n_post = d_out = 0, post_combine
    with d_in = d_latent = n_pre = 0."""
    k = k_step
    out = [("w_in", None, r, min(k, d_in - r), None)
           for r in range(0, d_in, k)]
    for b in range(n_pre):
        out += [("wz", b, r, k, r) for r in range(0, d_latent, k)]
        out += [(name, b, r, k, None) for name in ("w0", "w1")
                for r in range(0, hidden, k)]
    for b in range(n_post):
        out += [(name, b, r, k, None) for name in ("w0p", "w1p")
                for r in range(0, hidden, k)]
    if d_out:
        step = f32_out_rows(hidden, d_out, k)
        out += [("w_out", None, r, min(step, hidden - r), None)
                for r in range(0, hidden, step)]
    return out


def smem_bytes_tc(hidden: int) -> int:
    """Shared memory of the tensor-core kernel: alignment slack, the ring
    (16 x H weight slice + 64 x 16 latent slice per stage), the residual
    stream and the fc_0 output (64 x (H + 8) each), the barriers.  It does
    not grow with d_latent."""
    stage = TC_K_STEP * hidden * 2 + TC_ROWS * TC_K_STEP * 2
    return (1024 + TC_STAGES * stage + 2 * TC_ROWS * (hidden + TC_ROW_PAD) * 2
            + 16 * TC_STAGES)


def fits(d_in: int, d_latent: int, hidden: int, compute_dtype,
         mode: str = "full_pe", d_out: int = 4) -> bool:
    """Whether the kernel of ``mode`` takes these widths: hidden a multiple
    of 64 up to 512 and the CTA's shared memory (which grows with hidden
    only) within the limit; before the combine (every mode but
    post_combine) also the z-features, rounded up to the K step (16 in
    both variants), no wider than hidden and d_latent a multiple of the
    same; with lin_out (full_pe, post_combine) a d_out that the variant
    takes, no wider than hidden: in bf16 one of ``tc_out_width``'s widths
    (d_out <= 256), in f32 up to F32_MAX_OUT (256)."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        return False
    tc = variant(mode, compute_dtype) == "tensor_core"
    smem = smem_bytes_tc(hidden) if tc else smem_bytes_f32(hidden)
    ok = hidden % HIDDEN_STEP == 0 and 0 < hidden <= MAX_HIDDEN \
        and smem <= SMEM_LIMIT
    if mode != "post_combine":
        k = TC_K_STEP if tc else F32_K_STEP
        ok = ok and (-(-d_in // k) * k <= hidden
                     and d_latent > 0 and d_latent % k == 0)
    if mode in ("full_pe", "post_combine"):
        width = tc_out_width(d_out) if tc else (
            d_out if 0 < d_out <= F32_MAX_OUT else None)
        ok = ok and width is not None and width <= hidden
    return ok


class KernelBuildError(RuntimeError):
    pass


_libraries: dict = {}
# per library: path, the compiler's output (ptxas -v: registers, spills,
# shared memory per kernel) and the seconds its nvcc took
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise KernelBuildError("nvcc not found (PATH or CUDA_HOME)")


def build() -> dict:
    """Compile each source of SOURCES (once per source and flags), one nvcc
    per source, all started together; return {name: library path}.  The
    compiler's report lands in ``build_info``."""
    outs, procs = {}, {}
    for name, source in SOURCES.items():
        src = source.read_bytes()
        tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()) \
            .hexdigest()[:16]
        out = BUILD_DIR / f"lib{name}_{tag}.so"
        outs[name] = out
        if out.exists():
            log = out.with_suffix(".log")
            build_info[name] = {"path": str(out), "seconds": 0.0,
                                "log": log.read_text() if log.exists() else ""}
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, time.perf_counter())
    failed = []
    for name, (proc, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc {SOURCES[name].name} failed "
                          f"({proc.returncode}):\n{log}")
            continue
        outs[name].with_suffix(".log").write_text(log)
        os.replace(tmp, outs[name])
        build_info[name] = {"path": str(outs[name]), "log": log,
                            "seconds": time.perf_counter() - t0}
    if failed:
        raise KernelBuildError("\n".join(failed))
    return outs


def load_library() -> dict:
    """Build and load the two libraries; check that their tiling constants
    agree with this module's mirrors."""
    if not _libraries:
        paths = build()
        tc = bind_tc(paths["field_mlp_tc"])
        consts = ("rows_per_cta", "k_step", "stages", "cluster", "row_pad")
        got = tuple(getattr(tc, f"field_mlp_tc_{c}")() for c in consts)
        if got != (TC_ROWS, TC_K_STEP, TC_STAGES, TC_CLUSTER, TC_ROW_PAD):
            raise KernelBuildError(
                f"tensor-core kernel tiling constants disagree: {got}")
        if any(tc.field_mlp_tc_out_width(d) != (tc_out_width(d) or 0)
               for d in range(TC_OUT_WIDTHS[-1] + 2)):
            raise KernelBuildError("tensor-core lin_out widths disagree")
        f32 = bind_f32(paths["field_mlp_f32"])
        check_f32(f32)
        _libraries.update(field_mlp_tc=tc, field_mlp_f32=f32)
    return _libraries


def bind_f32(path) -> ctypes.CDLL:
    """Load a build of field_mlp_f32.cu and declare its C interface."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    f32 = ctypes.CDLL(str(path))
    f32.field_mlp_f32_launch.argtypes = (
        [ci] + [vp] * 19 + [ci] * 8 + [ctypes.c_float, vp]
    )
    f32.field_mlp_f32_launch.restype = ci
    f32.field_mlp_f32_error_string.argtypes = [ci]
    f32.field_mlp_f32_error_string.restype = ctypes.c_char_p
    for c in ("rows_per_cta", "k_step", "stages", "cluster", "max_out"):
        getattr(f32, f"field_mlp_f32_{c}").restype = ci
    f32.field_mlp_f32_smem_bytes.argtypes = [ci]
    f32.field_mlp_f32_smem_bytes.restype = ci
    f32.field_mlp_f32_walk_stages.argtypes = [ci] * 6
    f32.field_mlp_f32_walk_stages.restype = ci
    f32.field_mlp_f32_out_rows.argtypes = [ci] * 2
    f32.field_mlp_f32_out_rows.restype = ci
    return f32


# (d_in, d_latent, hidden, n_pre, n_post, d_out) at which ``check_f32``
# holds the f32 kernel's walk to ``f32_schedule``: full_pe at the NeRF and
# YOLO widths and narrow ones, pre_combine_pe, pre_combine (no post
# stage), post_combine (no pre stage) with NeRF's, YOLO's and other heads
F32_WALK_CHECKS = ((42, 512, 512, 3, 2, 4), (42, 1792, 512, 3, 2, 21),
                   (42, 512, 512, 3, 0, 0), (78, 1792, 512, 3, 0, 0),
                   (6, 48, 128, 1, 1, 1), (42, 64, 64, 0, 2, 64),
                   (0, 0, 512, 0, 2, 4), (0, 0, 512, 0, 2, 21),
                   (0, 0, 192, 0, 1, 100), (0, 0, 512, 0, 0, 256))


def check_f32(f32, consts=(F32_ROWS, F32_K_STEP, F32_STAGES, F32_CLUSTER)):
    """Raise unless a build of field_mlp_f32.cu has the tiling constants
    ``consts`` (rows, stage depth, stages, cluster) and the lin_out limit
    F32_MAX_OUT, and agrees with this module's mirrors of its shared
    memory (every hidden width) and of its walk (F32_WALK_CHECKS: stage
    counts and lin_out's rows a stage)."""
    got = tuple(getattr(f32, f"field_mlp_f32_{c}")()
                for c in ("rows_per_cta", "k_step", "stages", "cluster"))
    if got != tuple(consts):
        raise KernelBuildError(f"f32 kernel tiling constants disagree: {got}")
    if f32.field_mlp_f32_max_out() != F32_MAX_OUT:
        raise KernelBuildError("f32 kernel lin_out limit disagrees")
    k, stages = consts[1], consts[2]
    if any(f32.field_mlp_f32_smem_bytes(h) != smem_bytes_f32(h, k, stages)
           for h in range(HIDDEN_STEP, MAX_HIDDEN + 1, HIDDEN_STEP)):
        raise KernelBuildError("f32 kernel shared memory disagrees")
    for shape in F32_WALK_CHECKS:
        if shape[1] % k or shape[2] % k:  # widths this build does not take
            continue
        d_out = shape[5]
        if f32.field_mlp_f32_walk_stages(*shape) != len(
                f32_schedule(*shape, k_step=k)) or (d_out and (
                    f32.field_mlp_f32_out_rows(shape[2], d_out)
                    != f32_out_rows(shape[2], d_out, k))):
            raise KernelBuildError(f"f32 kernel walk disagrees at {shape}")


def bind_tc(path) -> ctypes.CDLL:
    """Load a build of field_mlp_tc.cu and declare its C interface."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    tc = ctypes.CDLL(str(path))
    tc.field_mlp_tc_launch.argtypes = (
        [ci] + [vp] * 13 + [ci] * 8 + [ctypes.c_float, vp]
    )
    tc.field_mlp_tc_launch.restype = ci
    tc.field_mlp_tc_error_string.argtypes = [ci]
    tc.field_mlp_tc_error_string.restype = ctypes.c_char_p
    for c in ("rows_per_cta", "k_step", "stages", "cluster", "row_pad"):
        getattr(tc, f"field_mlp_tc_{c}").restype = ci
    tc.field_mlp_tc_out_width.argtypes = [ci]
    tc.field_mlp_tc_out_width.restype = ci
    return tc


def _check(t: torch.Tensor, name: str, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _check_weights(w: StackedWeights, cdt, device, d_in, d_latent, pre: bool,
                   post: bool):
    H = w.hidden
    f32 = torch.float32
    if pre:
        cl = w.wz.shape[0]
        _check(w.w_in, "w_in", (d_in, H), cdt, device)
        _check(w.b_in, "b_in", (H,), f32, device)
        _check(w.wz, "wz", (cl, d_latent, H), cdt, device)
        _check(w.bz, "bz", (cl, H), f32, device)
        for name in ("w0", "w1"):
            _check(getattr(w, name), name, (cl, H, H), cdt, device)
        for name in ("b0", "b1"):
            _check(getattr(w, name), name, (cl, H), f32, device)
    if post:
        n_post = w.w0p.shape[0]
        for name in ("w0p", "w1p"):
            _check(getattr(w, name), name, (n_post, H, H), cdt, device)
        for name in ("b0p", "b1p"):
            _check(getattr(w, name), name, (n_post, H), f32, device)
        _check(w.w_out, "w_out", (H, w.w_out.shape[1]), cdt, device)
        _check(w.b_out, "b_out", (w.w_out.shape[1],), f32, device)


def _launch(mode: str, cdt, device, n_rows, d_in, d_latent, w, base=None,
            zfeat=None, latent=None, h=None, out=None, num_freqs=0,
            freq_factor=0.0):
    if device.type != "cuda":
        raise ValueError(f"field MLP kernels run on CUDA tensors, got {device}")
    d_out = w.w_out.shape[1]
    if not fits(d_in, d_latent, w.hidden, cdt, mode, d_out):
        raise ValueError(
            f"field MLP kernel does not take hidden={w.hidden} "
            f"d_latent={d_latent} d_in={d_in} d_out={d_out} dtype={cdt}"
        )
    libs = load_library()

    def ptr(t):
        return None if t is None else t.data_ptr()

    post = mode in ("full_pe", "post_combine")
    n_pre = w.wz.shape[0] if mode != "post_combine" else 0
    n_post = w.w0p.shape[0] if post else 0
    stream = torch.cuda.current_stream(device).cuda_stream
    var = variant(mode, cdt)
    name = LIBRARY[var]
    lib = libs[name]
    if var == "tensor_core":
        if latent is not None and latent.data_ptr() % 16:
            raise ValueError("latent must start on a 16-byte boundary (TMA)")
        if h is not None and h.data_ptr() % 16:
            raise ValueError("h must start on a 16-byte boundary")
        packed = tc_weights(w)
        wpack = packed.data_ptr()
        if mode == "post_combine":  # the walk starts at the first post block
            wpack += (tc_stages(w)[0] * TC_K_STEP * w.hidden
                      * packed.element_size())
        with torch.cuda.device(device):
            err = lib.field_mlp_tc_launch(
                MODES[mode], ptr(base), ptr(zfeat), ptr(latent), ptr(h),
                wpack, ptr(w.b_in), ptr(w.bz), ptr(w.b0), ptr(w.b1),
                ptr(w.b0p), ptr(w.b1p), ptr(w.b_out), ptr(out), n_rows, d_in,
                d_latent, w.hidden, n_pre, n_post, d_out, num_freqs,
                float(freq_factor), stream,
            )
        error_string = lib.field_mlp_tc_error_string
    else:
        # what the ring kernel reads with bulk, TMA or 128-bit accesses:
        # before the combine the latent and the pre stacks, after it h
        # (post_combine) and the post stacks and w_out
        aligned = ([("h", h)] if mode == "post_combine" else
                   [("latent", latent)] + [(f, getattr(w, f))
                                           for f in WEIGHT_NAMES[:8]])
        if post:
            aligned += [(f, getattr(w, f)) for f in WEIGHT_NAMES[8:13]]
        for label, t in aligned:
            if t.data_ptr() % 16:
                raise ValueError(f"{label} must start on a 16-byte boundary "
                                 "(TMA, bulk copies and 16-byte loads)")
        with torch.cuda.device(device):
            err = lib.field_mlp_f32_launch(
                MODES[mode], ptr(base), ptr(zfeat), ptr(h), ptr(latent),
                *(ptr(getattr(w, f)) for f in WEIGHT_NAMES), ptr(out),
                n_rows, d_in, d_latent, w.hidden, n_pre, n_post,
                d_out if post else 0, num_freqs, float(freq_factor), stream,
            )
        error_string = lib.field_mlp_f32_error_string
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(f"{name} {mode} launch failed: {msg} ({err})")
    launches[mode] += 1
    key = f"{mode}/{var}"
    variant_launches[key] = variant_launches.get(key, 0) + 1
    return out


def _pe_args(base, latent, w, code):
    n, dL = latent.shape
    d_in = code.d_out + 3
    if not (code.d_in == 3 and code.include_input and code.num_freqs > 0):
        raise ValueError("the in-kernel PE takes xyz with include_input")
    _check(base, "base", (n, 6), torch.float32, latent.device)
    _check(latent, "latent", (n, dL), latent.dtype, latent.device)
    _check_weights(w, latent.dtype, latent.device, d_in, dL, pre=True,
                   post=False)
    return n, dL, d_in


def full_pe(base, latent, w: StackedWeights, code) -> torch.Tensor:
    """(N, 6) f32, (N, dL) cdt -> (N, d_out) f32: the whole ResnetFC."""
    if latent.device.type == "cpu":
        return full_pe_plain(base, latent, w, code)
    n, dL, d_in = _pe_args(base, latent, w, code)
    _check_weights(w, latent.dtype, latent.device, d_in, dL, pre=False,
                   post=True)
    out = torch.empty((n, w.w_out.shape[1]), dtype=torch.float32,
                      device=latent.device)
    return _launch("full_pe", latent.dtype, latent.device, n, d_in, dL, w,
                   base=base, latent=latent, out=out,
                   num_freqs=code.num_freqs, freq_factor=code.freq_factor)


def pre_combine_pe(base, latent, w: StackedWeights, code) -> torch.Tensor:
    """(N, 6) f32, (N, dL) cdt -> h (N, H) cdt: PE, lin_in, CL blocks."""
    if latent.device.type == "cpu":
        return pre_combine_pe_plain(base, latent, w, code)
    n, dL, d_in = _pe_args(base, latent, w, code)
    out = torch.empty((n, w.hidden), dtype=latent.dtype, device=latent.device)
    return _launch("pre_combine_pe", latent.dtype, latent.device, n, d_in,
                   dL, w, base=base, latent=latent, out=out,
                   num_freqs=code.num_freqs, freq_factor=code.freq_factor)


def pre_combine(zfeat, latent, w: StackedWeights) -> torch.Tensor:
    """(N, d_in) cdt, (N, dL) cdt -> h (N, H) cdt: lin_in on the given
    z-features, CL blocks."""
    if latent.device.type == "cpu":
        return pre_combine_plain(zfeat, latent, w)
    n, dL = latent.shape
    cdt, dev = latent.dtype, latent.device
    d_in = w.w_in.shape[0]
    _check(zfeat, "zfeat", (n, d_in), cdt, dev)
    _check(latent, "latent", (n, dL), cdt, dev)
    _check_weights(w, cdt, dev, d_in, dL, pre=True, post=False)
    out = torch.empty((n, w.hidden), dtype=cdt, device=dev)
    return _launch("pre_combine", cdt, dev, n, d_in, dL, w, zfeat=zfeat,
                   latent=latent, out=out)


def post_combine(h, w: StackedWeights) -> torch.Tensor:
    """(N, H) cdt -> (N, d_out) f32: post-combine blocks and lin_out."""
    if h.device.type == "cpu":
        return post_combine_plain(h, w)
    n = h.shape[0]
    _check(h, "h", (n, w.hidden), h.dtype, h.device)
    _check_weights(w, h.dtype, h.device, 0, 0, pre=False, post=True)
    out = torch.empty((n, w.w_out.shape[1]), dtype=torch.float32,
                      device=h.device)
    return _launch("post_combine", h.dtype, h.device, n, 0, 0, w, h=h,
                   out=out)


def fused_pe_forward(mlp, latent, base, ns: int, inner_b: int,
                     compute_dtype: torch.dtype,
                     code: PositionalEncoding) -> torch.Tensor:
    """The fused field (``_fused_pe_forward``).

    :param latent (SB*NS*B, dL), rows ordered (sb, v, b)
    :param base (SB*NS*B, 6) = [xyz rotated into the camera, viewdirs rotated]
    :return (SB*B, d_out) f32
    """
    w = stacked_params(mlp, compute_dtype)
    latent = latent.to(compute_dtype).contiguous()
    base = base.float().contiguous()
    if ns == 1 and mlp.combine_layer < mlp.n_blocks:
        # no cross-view mean: one kernel, the (N, H) state stays on chip
        return full_pe(base, latent, w, code)
    # NS > 1, or NS == 1 with no post-combine block (post_combine then
    # runs lin_out alone)
    return _combine_post(pre_combine_pe(base, latent, w, code), w, ns,
                         inner_b)


def _combine_post(h, w: StackedWeights, ns: int, inner_b: int):
    """The f32 view mean (NS > 1), then the post_combine kernel."""
    cdt = h.dtype
    if ns > 1:
        H = h.shape[-1]
        h = h.reshape(-1, ns, inner_b, H).float().mean(dim=1).reshape(-1, H)
    return post_combine(h.to(cdt).contiguous(), w)


def fused_forward(mlp, latent, zfeat, ns: int, inner_b: int,
                  compute_dtype: torch.dtype) -> torch.Tensor:
    """The fused field on precomputed z-features (``_fused_forward``):
    pre_combine, the view mean when NS > 1, post_combine, even at NS == 1
    (there is no whole-MLP kernel without the PE stage).

    :param latent (SB*NS*B, dL), rows ordered (sb, v, b)
    :param zfeat (SB*NS*B, d_in), cast to the compute dtype here
    :return (SB*B, d_out) f32
    """
    w = stacked_params(mlp, compute_dtype)
    h = pre_combine(zfeat.to(compute_dtype).contiguous(),
                    latent.to(compute_dtype).contiguous(), w)
    return _combine_post(h, w, ns, inner_b)


# -- autograd ----------------------------------------------------------------


def plain_field(mlp, params: dict, latent, zfeat, ns: int, inner_b: int):
    """The plain ResnetFC with the given parameters on [latent, zfeat], both
    cast to f32 (the JAX package's ``xla_fallback``).

    :return (SB*B, d_out) f32
    """
    zx = torch.cat([latent.float(), zfeat.float()], dim=-1)
    out = torch.func.functional_call(mlp, params, (zx,),
                                     {"combine_inner_dims": (ns, inner_b)})
    return out.reshape(-1, mlp.d_out)


class _FusedField(torch.autograd.Function):
    """Kernel forward, plain-module backward; ``apply(mlp, code, ns,
    inner_b, compute_dtype, latent, x, *mlp.parameters())`` with x the
    z-features (code None) or the PE base."""

    @staticmethod
    def forward(ctx, mlp, code, ns, inner_b, compute_dtype, latent, x,
                *params):
        ctx.mlp, ctx.code, ctx.ns, ctx.inner_b = mlp, code, ns, inner_b
        ctx.save_for_backward(latent, x, *params)
        if code is None:
            return fused_forward(mlp, latent, x, ns, inner_b, compute_dtype)
        return fused_pe_forward(mlp, latent, x, ns, inner_b, compute_dtype,
                                code)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[5:]
        inputs = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
        names = [name for name, _ in ctx.mlp.named_parameters()]
        with torch.enable_grad():
            latent, x = inputs[:2]
            zfeat = x if ctx.code is None else pe_features(x, ctx.code)
            out = plain_field(ctx.mlp, dict(zip(names, inputs[2:])), latent,
                              zfeat, ctx.ns, ctx.inner_b)
        wrt = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wrt, g, allow_unused=True))
        return (None,) * 5 + tuple(next(grads) if t.requires_grad else None
                                   for t in inputs)


class FusedResnetFC(_FusedField):
    """``fused_forward`` with the plain module's gradients (JAX
    ``fused_resnetfc``): ``FusedResnetFC.apply(mlp, None, ns, inner_b,
    compute_dtype, latent, zfeat, *mlp.parameters())``."""


class FusedResnetFCPE(_FusedField):
    """``fused_pe_forward`` with the plain module's gradients, the PE taken
    in the recompute first (JAX ``fused_resnetfc_pe``):
    ``FusedResnetFCPE.apply(mlp, code, ns, inner_b, compute_dtype, latent,
    base, *mlp.parameters())``."""


def fused_field(mlp, latent, x, ns: int, inner_b: int,
                compute_dtype: torch.dtype, code=None) -> torch.Tensor:
    """The fused field, differentiable: ``fused_pe_forward`` on the PE base
    x when code is given, else ``fused_forward`` on the z-features x."""
    fn = FusedResnetFC if code is None else FusedResnetFCPE
    return fn.apply(mlp, code, ns, inner_b, compute_dtype, latent, x,
                    *mlp.parameters())
