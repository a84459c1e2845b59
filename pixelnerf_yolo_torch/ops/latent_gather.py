"""The bilinear latent lookup's CUDA kernel (csrc/latent_gather.cu) and its
wrapper.

``grid_sample_nhwc`` (ops/grid_sample.py) launches it in place of its plain
chain (``_corners`` + ``_combine``) for a bilinear lookup of a CUDA table of
f32, bf16 or f16 that records no gradient; its result is the chain's,
bitwise.  The entry is a ``torch.library.custom_op``
(``pixelnerf_yolo::latent_gather``), so an exported render (serve.py)
records it as one node: its CUDA kernel checks the operands and launches the
kernel (counting the launch in ``launches``), its CPU kernel runs the plain
chain.  The library is built and loaded with the field kernels'
(``field_mlp.build`` / ``load_library``: one nvcc per source, started
together, cached in ``_build/``).
"""

from __future__ import annotations

import ctypes

import torch

DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
PADDINGS = {"zeros": 0, "border": 1, "reflection": 2}
launches = 0


def bind(path) -> ctypes.CDLL:
    """Load a build of latent_gather.cu and declare its C interface."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib = ctypes.CDLL(str(path))
    lib.latent_gather_launch.argtypes = [ci] + [vp] * 3 + [ci] * 8 + [vp]
    lib.latent_gather_launch.restype = ci
    lib.latent_gather_error_string.argtypes = [ci]
    lib.latent_gather_error_string.restype = ctypes.c_char_p
    return lib


def _check(flat, grid, height, width, padding_mode):
    if padding_mode not in PADDINGS:
        raise NotImplementedError(f"grid_sample padding {padding_mode!r}")
    if flat.device.type != "cuda" or grid.device != flat.device:
        raise ValueError(f"latent gather runs on one CUDA device, got table "
                         f"on {flat.device}, grid on {grid.device}")
    if flat.dtype not in DTYPES:
        raise ValueError(f"table dtype {flat.dtype} is not f32, bf16 or f16")
    if grid.dtype != torch.float32:
        raise ValueError(f"grid dtype {grid.dtype}, expected float32")
    if (flat.dim() != 3 or flat.shape[1] != height * width
            or flat.shape[2] == 0):
        raise ValueError(f"table has shape {tuple(flat.shape)}, expected "
                         f"(B, {height * width}, C > 0)")
    if grid.dim() != 3 or grid.shape[0] != flat.shape[0] or grid.shape[2] != 2:
        raise ValueError(f"grid has shape {tuple(grid.shape)}, expected "
                         f"({flat.shape[0]}, N, 2)")
    for name, t in (("table", flat), ("grid", grid)):
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if grid.data_ptr() % 8:
        raise ValueError("grid must start on an 8-byte boundary")


@torch.library.custom_op("pixelnerf_yolo::latent_gather", mutates_args=(),
                         device_types="cuda")
def latent_gather(flat: torch.Tensor, grid: torch.Tensor, height: int,
                  width: int, padding_mode: str,
                  align_corners: bool) -> torch.Tensor:
    """The bilinear lookup of grid (B, N, 2) f32 in flat (B, height * width,
    C): (B, N, C) in flat's dtype, as ``grid_sample_nhwc`` computes it."""
    global launches
    from .field_mlp import load_library

    _check(flat, grid, height, width, padding_mode)
    B, R, C = flat.shape
    N = grid.shape[1]
    out = torch.empty((B, N, C), dtype=flat.dtype, device=flat.device)
    lib = load_library()["latent_gather"]
    stream = torch.cuda.current_stream(flat.device).cuda_stream
    with torch.cuda.device(flat.device):
        err = lib.latent_gather_launch(
            DTYPES[flat.dtype], flat.data_ptr(), grid.data_ptr(),
            out.data_ptr(), B, R, N, C, height, width,
            PADDINGS[padding_mode], int(align_corners), stream)
    if err != 0:
        msg = lib.latent_gather_error_string(err).decode()
        raise RuntimeError(f"latent_gather launch failed: {msg} ({err})")
    launches += 1
    return out


@latent_gather.register_kernel("cpu")
def _(flat, grid, height, width, padding_mode, align_corners):
    from .grid_sample import _combine, _corners

    return _combine(flat, _corners(grid, height, width, padding_mode,
                                   align_corners), flat.dtype)


@latent_gather.register_fake
def _(flat, grid, height, width, padding_mode, align_corners):
    return flat.new_empty((flat.shape[0], grid.shape[1], flat.shape[2]))
