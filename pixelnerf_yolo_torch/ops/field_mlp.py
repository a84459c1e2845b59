"""Fused field MLP: hand-written Hopper kernels and their plain twins.

Counterpart of pixelnerf_yolo_tpu/ops/pallas/fused_mlp.py.  Three kernels
(csrc/field_mlp.cu, CUDA C++ for sm_90a) replace the three Pallas kernels
on the NeRF render path:

  full_pe         <- fused_full_pe         whole ResnetFC, NS == 1
  pre_combine_pe  <- fused_pre_combine_pe  PE + lin_in + pre-combine blocks
  post_combine    <- fused_post_combine    post-combine blocks + lin_out

Each wrapper runs its plain twin (``*_plain``: the same function with the
same rounding points, in plain torch) when its tensors lie on the CPU,
launches its kernel when they lie on a CUDA device, and raises otherwise.
``launches`` counts kernel launches per wrapper.

Rounding points (shared by kernels and twins): each Dense is an f32
accumulation plus an f32 bias, then one cast to the compute dtype; the
residual stream stays in the compute dtype; lin_out takes the compute-dtype
w_out and returns f32.  The library is compiled with nvcc at first use into
``_build/`` beside this package and bound with ctypes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import weakref
from pathlib import Path

import torch

from ..nn.code import PositionalEncoding

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR / "csrc" / "field_mlp.cu"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Mirrors of the kernel's tiling constants (checked against the library
# when it loads) and the per-block shared-memory limit of sm_90.
ROWS_PER_BLOCK = 32
WEIGHT_TILE_ROWS = 16
COLUMN_LANES = 64
MAX_HIDDEN = 512
SMEM_LIMIT = 232448

MODES = {"full_pe": 0, "pre_combine_pe": 1, "post_combine": 2}
launches = {name: 0 for name in MODES}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


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

    @property
    def hidden(self) -> int:
        return self.w_in.shape[1]


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


def _pre(base, latent, w: StackedWeights, code):
    cdt = latent.dtype
    x = _dense(pe_features(base, code).to(cdt), w.w_in, w.b_in, cdt)
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
    return _post(_pre(base, latent, w, code), w)


def pre_combine_pe_plain(base, latent, w: StackedWeights, code) -> torch.Tensor:
    return _pre(base, latent, w, code)


def post_combine_plain(h, w: StackedWeights) -> torch.Tensor:
    return _post(h, w)


# -- the kernels -------------------------------------------------------------


def smem_bytes(mode: str, elt_bytes: int, hidden: int, d_latent: int) -> int:
    lat = 0 if mode == "post_combine" else ROWS_PER_BLOCK * d_latent
    return elt_bytes * (2 * ROWS_PER_BLOCK * hidden + lat
                        + WEIGHT_TILE_ROWS * hidden)


def fits(d_in: int, d_latent: int, hidden: int, compute_dtype,
         mode: str = "full_pe") -> bool:
    """Whether the kernel of ``mode`` takes these widths: hidden a multiple
    of 64 up to 512 and the block's tiles within the shared-memory limit;
    with the PE stage also the PE features no wider than hidden and
    d_latent a multiple of the weight tile."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        return False
    elt = torch.empty((), dtype=compute_dtype).element_size()
    ok = (
        hidden % COLUMN_LANES == 0
        and 0 < hidden <= MAX_HIDDEN
        and smem_bytes(mode, elt, hidden, d_latent) <= SMEM_LIMIT
    )
    if mode != "post_combine":
        ok = ok and (
            -(-d_in // WEIGHT_TILE_ROWS) * WEIGHT_TILE_ROWS <= hidden
            and d_latent > 0 and d_latent % WEIGHT_TILE_ROWS == 0
        )
    return ok


class KernelBuildError(RuntimeError):
    pass


_library = None
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise KernelBuildError("nvcc not found (PATH or CUDA_HOME)")


def build() -> Path:
    """Compile csrc/field_mlp.cu (once per source and flags) and return the
    shared library's path.  The compiler's register and shared-memory
    report lands in ``build_info``."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libfield_mlp_{tag}.so"
    if out.exists():
        build_info.update(path=str(out), log="")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    build_info.update(path=str(out), log=proc.stdout + proc.stderr)
    return out


def load_library() -> ctypes.CDLL:
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.field_mlp_launch.argtypes = (
            [ci, ci] + [vp] * 18 + [ci] * 8 + [ctypes.c_float, vp]
        )
        lib.field_mlp_launch.restype = ci
        lib.field_mlp_error_string.argtypes = [ci]
        lib.field_mlp_error_string.restype = ctypes.c_char_p
        lib.field_mlp_rows_per_block.restype = ci
        lib.field_mlp_weight_tile_rows.restype = ci
        if (lib.field_mlp_rows_per_block(), lib.field_mlp_weight_tile_rows()) \
                != (ROWS_PER_BLOCK, WEIGHT_TILE_ROWS):
            raise KernelBuildError("kernel tiling constants disagree")
        _library = lib
    return _library


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
            latent=None, h=None, out=None, num_freqs=0, freq_factor=0.0):
    if device.type != "cuda":
        raise ValueError(f"field MLP kernels run on CUDA tensors, got {device}")
    if not fits(d_in, d_latent, w.hidden, cdt, mode):
        raise ValueError(
            f"field MLP kernel does not take hidden={w.hidden} "
            f"d_latent={d_latent} d_in={d_in} dtype={cdt}"
        )
    lib = load_library()

    def ptr(t):
        return None if t is None else t.data_ptr()

    n_pre = w.wz.shape[0] if mode != "post_combine" else 0
    n_post = w.w0p.shape[0] if mode != "pre_combine_pe" else 0
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = lib.field_mlp_launch(
            MODES[mode], int(cdt == torch.bfloat16), ptr(base), ptr(latent),
            ptr(h), *(ptr(getattr(w, f.name)) for f in dataclasses.fields(w)),
            ptr(out),
            n_rows, d_in, d_latent, w.hidden, n_pre, n_post,
            w.w_out.shape[1], num_freqs, float(freq_factor), stream,
        )
    if err != 0:
        msg = lib.field_mlp_error_string(err).decode()
        raise RuntimeError(f"field_mlp {mode} launch failed: {msg} ({err})")
    launches[mode] += 1
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
    h = pre_combine_pe(base, latent, w, code)
    if ns > 1:
        H = h.shape[-1]
        h = h.reshape(-1, ns, inner_b, H).float().mean(dim=1).reshape(-1, H)
    return post_combine(h.to(compute_dtype).contiguous(), w)
