"""The host side of the tensor-core field-MLP kernel (csrc/field_mlp_tc.cu):
the packed weight stream, its feasibility check and the routing between
the two kernel variants.  No GPU needed.

The kernel reads the packed weights as 16-deep K slices in wgmma's K-major
core-matrix layout; these tests hold the packing against ``stack_params``
and the plain twin, so that a packing fault shows here and not only as a
wrong product on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pixelnerf_yolo_torch.nn.code import PositionalEncoding
from pixelnerf_yolo_torch.nn.resnetfc import ResnetFC
from pixelnerf_yolo_torch.ops import field_mlp as fm

# (d_in, d_latent, hidden): NeRF, use_code_viewdirs and YOLO flagship
# widths, then the tests' narrow ones
WIDTHS = [(42, 512, 512), (78, 512, 512), (42, 1792, 512), (42, 48, 128),
          (78, 64, 128), (6, 64, 64)]


def _unpack_layer(flat, K, H):
    """Inverse of ``field_mlp._pack_layer``."""
    return flat.reshape(K // 16, H // 8, 2, 8, 8).permute(0, 2, 4, 1, 3) \
        .reshape(K, H)


def unpack_tc(packed, d_in, d_latent, hidden, n_pre):
    """Inverse of ``field_mlp.pack_tc``: (w_in, wz, w0, w1) as
    ``stack_params`` gives them."""
    dz = -(-d_in // fm.TC_K_STEP) * fm.TC_K_STEP
    sizes = [dz * hidden] + [d_latent * hidden, hidden * hidden,
                             hidden * hidden] * n_pre
    parts = list(torch.split(packed, sizes))
    blocks = [[_unpack_layer(parts[1 + 3 * i + j], K, hidden)
               for j, K in enumerate((d_latent, hidden, hidden))]
              for i in range(n_pre)]
    stacks = [torch.stack([b[j] for b in blocks]) for j in range(3)]
    return (_unpack_layer(parts[0], dz, hidden)[:d_in], *stacks)


def _weights(d_in, d_latent, hidden, dtype=torch.bfloat16, seed=0):
    g = torch.Generator().manual_seed(seed)
    mlp = ResnetFC(d_in, d_out=4, n_blocks=5, d_latent=d_latent,
                   d_hidden=hidden, combine_layer=3, dtype=dtype, generator=g)
    with torch.no_grad():
        for name, p in mlp.named_parameters():
            if ".fc_1." in name or name.endswith("bias"):
                p.add_(torch.randn(p.shape, generator=g) * 0.02)
    return mlp, fm.stack_params(mlp, dtype)


@pytest.mark.parametrize("d_in,d_latent,hidden", WIDTHS)
def test_unpacked_weights_are_stack_params(d_in, d_latent, hidden):
    _, w = _weights(d_in, d_latent, hidden)
    packed = fm.pack_tc(w)
    dz = -(-d_in // fm.TC_K_STEP) * fm.TC_K_STEP
    n_pre = w.wz.shape[0]
    stages = dz // 16 + n_pre * (d_latent // 16 + 2 * hidden // 16)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert packed.numel() == stages * fm.TC_K_STEP * hidden
    got = unpack_tc(packed, d_in, d_latent, hidden, n_pre)
    for name, t in zip(("w_in", "wz", "w0", "w1"), got):
        assert torch.equal(t, getattr(w, name)), name
    # lin_in's rows past d_in, up to the K step, are zeros
    first = _unpack_layer(packed[:dz * hidden], dz, hidden)
    assert not first[d_in:].any()


def test_packed_slice_layout():
    """Element (16 t + 8 c + e, 8 q + r) of a layer sits in slice t at
    q * 128 + c * 64 + r * 8 + e: 8 x 8 core matrices of 16-byte rows,
    128 B apart along K and 256 B along N (the descriptor's LBO and SBO)."""
    _, w = _weights(42, 64, 128)
    packed = fm.pack_tc(w)
    H, dz = 128, 48
    rng = np.random.default_rng(0)
    for _ in range(50):
        t, c = rng.integers(0, dz // 16), rng.integers(0, 2)
        e = rng.integers(0, 8)
        q, r = rng.integers(0, H // 8), rng.integers(0, 8)
        k, n = 16 * t + 8 * c + e, 8 * q + r
        want = w.w_in[k, n] if k < 42 else torch.zeros((), dtype=w.w_in.dtype)
        assert packed[t * 16 * H + q * 128 + c * 64 + r * 8 + e] == want
    # lin_z of block 0 follows lin_in
    wz_at = dz * H
    assert packed[wz_at + 1 * 128 + 8 + 2] == w.wz[0, 2, 9]


@pytest.mark.parametrize("mode", ["pre_combine_pe", "pre_combine"])
@pytest.mark.parametrize("d_in,d_latent,hidden", WIDTHS[3:5])
def test_twin_on_unpacked_weights(mode, d_in, d_latent, hidden):
    """The plain twin fed the weights unpacked from the stream equals the
    twin on ``stack_params``'s."""
    if mode == "pre_combine_pe":
        d_in = 42
    _, w = _weights(d_in, d_latent, hidden)
    w_in, wz, w0, w1 = unpack_tc(fm.pack_tc(w), d_in, d_latent, hidden,
                                 w.wz.shape[0])
    wu = dataclasses.replace(w, w_in=w_in, wz=wz, w0=w0, w1=w1)
    g = torch.Generator().manual_seed(1)
    rows = 37
    lat = torch.randn((rows, d_latent), generator=g).bfloat16()
    if mode == "pre_combine_pe":
        base = torch.rand((rows, 6), generator=g) * 2 - 1
        code = PositionalEncoding(6, 3, 1.5, True)
        args, argsu = (base, lat, w, code), (base, lat, wu, code)
    else:
        zf = torch.randn((rows, d_in), generator=g).bfloat16()
        args, argsu = (zf, lat, w), (zf, lat, wu)
    twin = getattr(fm, mode + "_plain")
    assert torch.equal(twin(*argsu), twin(*args))


@pytest.mark.parametrize("hidden", [64, 128, 512])
@pytest.mark.parametrize("d_latent", [48, 512, 1792])
@pytest.mark.parametrize("d_in", [42, 78])
@pytest.mark.parametrize("mode", ["pre_combine_pe", "pre_combine"])
def test_fits_tensor_core_widths(mode, d_in, d_latent, hidden):
    """The tensor-core variant takes every latent width a multiple of its
    K step (its shared memory does not grow with d_latent) and z-features
    that, rounded up to the K step, fit in the hidden width: only d_in 78
    (80 rounded) at hidden 64 is refused."""
    want = not (d_in == 78 and hidden == 64)
    assert fm.fits(d_in, d_latent, hidden, torch.bfloat16, mode) is want


def test_fits_tensor_core_refusals():
    bf16 = torch.bfloat16
    assert not fm.fits(42, 512, 96, bf16, "pre_combine_pe")    # not x 64
    assert not fm.fits(42, 512, 1024, bf16, "pre_combine_pe")  # > 512
    assert not fm.fits(42, 40, 512, bf16, "pre_combine_pe")    # dL % 16
    assert not fm.fits(42, 0, 512, bf16, "pre_combine")
    assert not fm.fits(520, 512, 512, bf16, "pre_combine")
    # the CUDA-core variant keeps its own limits: f32 at dL 1792 does not fit
    assert not fm.fits(42, 1792, 512, torch.float32, "pre_combine_pe")


def test_tensor_core_shared_memory():
    sizes = {h: fm.smem_bytes_tc(h) for h in range(64, 513, 64)}
    assert all(s <= fm.SMEM_LIMIT for s in sizes.values())
    assert sizes[512] == 226384
    # 5 stages of (16 x 512 + 64 x 16) bf16 and two 64 x 520 tiles
    assert sizes[512] - 1024 - 16 * fm.TC_STAGES == (
        fm.TC_STAGES * (16 * 512 + 64 * 16) * 2 + 2 * 64 * 520 * 2)


@pytest.mark.parametrize("mode", list(fm.MODES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_routing(mode, dtype):
    """bf16 pre_combine_pe and pre_combine take the tensor-core kernel;
    f32, and full_pe and post_combine in either dtype, the CUDA-core one."""
    want = ("tensor_core" if dtype == torch.bfloat16
            and mode in ("pre_combine_pe", "pre_combine") else "cuda_core")
    assert fm.variant(mode, dtype) == want


def test_packed_weights_cached():
    mlp, _ = _weights(42, 64, 128)
    w = fm.stacked_params(mlp, torch.bfloat16)
    packed = fm.tc_weights(w)
    assert fm.tc_weights(w) is packed
    assert fm.tc_weights(fm.stacked_params(mlp, torch.bfloat16)) is packed
    with torch.no_grad():
        mlp.lin_in.weight.mul_(2.0)
    assert fm.tc_weights(fm.stacked_params(mlp, torch.bfloat16)) is not packed
