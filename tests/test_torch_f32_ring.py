"""The f32 pre-combine kernel's host side (csrc/field_mlp_f32.cu): which
kernel each mode and dtype takes, its feasibility and shared memory, the
walk of weight slices its producer issues, the fused route's choice of
its first kernel, and the twins it is held against on the card, here
against the JAX package's Pallas kernels (interpret mode on the CPU).
The kernel itself is held against its twins in tests/test_torch_kernels.py
on the card."""

from types import SimpleNamespace

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pixelnerf_yolo_tpu.ops.pallas import fused_mlp as jfm
from pixelnerf_yolo_torch.models.pixelnerf import PixelNeRF
from pixelnerf_yolo_torch.nn.code import PositionalEncoding
from pixelnerf_yolo_torch.nn.resnetfc import ResnetFC
from pixelnerf_yolo_torch.ops import field_mlp as fm

F32, BF16 = torch.float32, torch.bfloat16
# (d_in, d_latent, hidden): NeRF, use_code_viewdirs, YOLO, narrow ones
WIDTHS = {"nerf": (42, 512, 512), "viewdirs": (78, 512, 512),
          "yolo": (42, 1792, 512), "narrow": (42, 48, 128),
          "narrow_z": (78, 64, 192), "h64": (42, 64, 64)}


@pytest.mark.parametrize("dtype,want", [
    (F32, {"full_pe": "cuda_core", "post_combine": "cuda_core",
           "pre_combine_pe": "cuda_core_ring",
           "pre_combine": "cuda_core_ring"}),
    (BF16, dict.fromkeys(fm.MODES, "tensor_core"))])
@pytest.mark.parametrize("mode", list(fm.MODES))
def test_variant_routing(mode, dtype, want):
    """bf16 takes the tensor cores in every mode; f32 takes the ring kernel
    before the combine and field_mlp.cu after it; each variant names its
    own library."""
    var = fm.variant(mode, dtype)
    assert var == want[mode]
    assert fm.LIBRARY[var] in fm.SOURCES
    assert fm.SOURCES[fm.LIBRARY[var]].name == {
        "cuda_core": "field_mlp.cu", "tensor_core": "field_mlp_tc.cu",
        "cuda_core_ring": "field_mlp_f32.cu"}[var]


@pytest.mark.parametrize("widths", list(WIDTHS))
@pytest.mark.parametrize("mode", ["pre_combine_pe", "pre_combine"])
def test_fits_f32_ring_widths(mode, widths):
    """The ring kernel takes every width the tensor-core kernel takes:
    shared memory does not grow with d_latent (the YOLO 1792 fits), and
    z-features rounded up to 16 no wider than hidden (only 80 > 64
    fails)."""
    d_in, d_latent, hidden = WIDTHS[widths]
    want = -(-d_in // 16) * 16 <= hidden
    assert fm.fits(d_in, d_latent, hidden, F32, mode) is want
    assert fm.fits(d_in, d_latent, hidden, F32, mode) \
        is fm.fits(d_in, d_latent, hidden, BF16, mode)
    assert fm.smem_bytes_f32(hidden) <= fm.SMEM_LIMIT


def test_fits_f32_ring_refusals():
    assert not fm.fits(42, 512, 96, F32, "pre_combine_pe")     # not x 64
    assert not fm.fits(42, 512, 1024, F32, "pre_combine_pe")   # > 512
    assert not fm.fits(42, 40, 512, F32, "pre_combine_pe")     # dL % 16
    assert not fm.fits(42, 0, 512, F32, "pre_combine")
    assert not fm.fits(520, 512, 512, F32, "pre_combine")      # 528 > 512
    assert not fm.fits(78, 64, 64, F32, "pre_combine")         # 80 > 64
    # f32 full_pe stays on field_mlp.cu, whose latent tile grows with dL
    assert fm.fits(42, 512, 512, F32, "full_pe")
    assert not fm.fits(42, 1792, 512, F32, "full_pe")
    assert fm.fits(0, 0, 512, F32, "post_combine", 21)


def test_f32_ring_shared_memory():
    """4 stages of (16 x H + 32 x 16) f32, the 32 x H activation buffer,
    8 barriers and 128 bytes of alignment slack; 204,992 B at H = 512,
    under the 232,448 B limit, where a fifth stage would not fit."""
    sizes = {h: fm.smem_bytes_f32(h) for h in range(64, 513, 64)}
    assert sizes[512] == 204992
    assert sizes[512] == 128 + 4 * (16 * 512 + 32 * 16) * 4 \
        + 512 * 32 * 4 + 16 * 4
    assert all(s <= fm.SMEM_LIMIT for s in sizes.values())
    assert fm.smem_bytes_f32(512, stages=5) > fm.SMEM_LIMIT
    assert sorted(sizes.values()) == list(sizes.values())


def _weights(d_in, d_latent, hidden, n_pre, seed=0):
    g = torch.Generator().manual_seed(seed)
    mlp = ResnetFC(d_in, d_out=4, n_blocks=5, d_latent=d_latent,
                   d_hidden=hidden, combine_layer=n_pre, generator=g)
    with torch.no_grad():
        for p in mlp.parameters():
            p.add_(torch.randn(p.shape, generator=g))
    return fm.stack_params(mlp, F32)


@pytest.mark.parametrize("widths,n_pre", [("nerf", 3), ("viewdirs", 3),
                                          ("yolo", 3), ("narrow", 1),
                                          ("narrow_z", 0), ("h64", 3)])
def test_f32_schedule_round_trip(widths, n_pre):
    """The walk's slices, gathered in order from the stacked weights,
    rebuild w_in, wz, w0 and w1 exactly; each block's latent slices cover
    its columns in order beside lin_z's slices; every slice splits into
    16-byte pieces between the CTAs of a cluster; the count is the one
    the kernel's walk_stages computes."""
    d_in, d_latent, hidden = WIDTHS[widths]
    w = _weights(d_in, d_latent, hidden, n_pre)
    sched = fm.f32_schedule(d_in, d_latent, hidden, n_pre)
    parts = {}
    for name, blk, first, rows, lat in sched:
        m = getattr(w, name) if blk is None else getattr(w, name)[blk]
        assert 0 < rows <= fm.F32_K_STEP and first + rows <= m.shape[0]
        assert rows * hidden * 4 % (16 * fm.F32_CLUSTER) == 0
        assert (lat is not None) == (name == "wz")
        if lat is not None:
            assert lat == first and lat + fm.F32_K_STEP <= d_latent
        parts.setdefault((name, blk), []).append(m[first:first + rows])
    assert torch.equal(torch.cat(parts[("w_in", None)]), w.w_in)
    for name in ("wz", "w0", "w1"):
        for b in range(n_pre):
            assert torch.equal(torch.cat(parts[(name, b)]),
                               getattr(w, name)[b])
    assert len(parts) == 1 + 3 * n_pre
    assert len(sched) == -(-d_in // 16) + n_pre * (d_latent + 2 * hidden) \
        // 16
    # the order: lin_in, then per block lin_z, fc_0, fc_1
    order = [k for i, k in enumerate((s[0], s[1]) for s in sched)
             if i == 0 or k != (sched[i - 1][0], sched[i - 1][1])]
    assert order == [("w_in", None)] + [(n, b) for b in range(n_pre)
                                        for n in ("wz", "w0", "w1")]


@pytest.mark.parametrize("ns,first,fuse_f32", [(1, "full_pe", False),
                                               (3, "pre_combine_pe", True)])
def test_route_starts_at_its_first_kernel(ns, first, fuse_f32):
    """At the YOLO widths (1792-d latent) the f32 route through
    pre_combine_pe + post_combine fits (NS > 1), the one-kernel full_pe
    route (NS = 1) does not; bf16 takes both."""
    mlp = ResnetFC(42, d_out=21, n_blocks=5, d_latent=1792, d_hidden=64,
                   combine_layer=3)
    assert PixelNeRF._first_kernel(mlp, ns, True) == first
    assert PixelNeRF._first_kernel(mlp, ns, False) == "pre_combine"
    for dtype, want in ((F32, fuse_f32), (BF16, True)):
        stub = SimpleNamespace(use_fused_mlp="auto", d_in=42,
                               compute_dtype=dtype)
        assert PixelNeRF._can_fuse(stub, mlp, ns, first) is want


def test_route_without_post_blocks_starts_at_pre_combine_pe():
    mlp = ResnetFC(42, d_out=4, n_blocks=5, d_latent=64, d_hidden=64,
                   combine_layer=5)
    assert PixelNeRF._first_kernel(mlp, 1, True) == "pre_combine_pe"


# -- the f32 twins against the Pallas kernels --------------------------------

# f32: accumulation order only (tests/test_torch_field_mlp.py)
TOL = 2e-5
FREQS = tuple(1.5 * 2.0**i for i in range(6))


def _pair(d_in, d_latent, hidden, n_pre, seed=0):
    """The JAX package's stacked f32 weights and the port's, the same
    numbers (made with numpy)."""
    w = _weights(d_in, d_latent, hidden, n_pre, seed)
    with torch.no_grad():
        for name in fm.WEIGHT_NAMES:
            getattr(w, name).mul_(0.05 if name[0] == "w" else 1.0)
    js = tuple(jnp.asarray(getattr(w, k).numpy()) for k in fm.WEIGHT_NAMES)
    return js, w


@pytest.mark.parametrize("d_latent,n_pre,rows", [(1792, 3, 200), (64, 1, 129),
                                                 (48, 3, 40)])
def test_pre_combine_pe_twin_matches_pallas_f32(rng, d_latent, n_pre, rows):
    """The ring kernel's twin at the YOLO latent width and with one block,
    on ragged rows, against ``fused_pre_combine_pe``."""
    js, w = _pair(42, d_latent, 64, n_pre)
    latent = rng.normal(size=(rows, d_latent)).astype(np.float32)
    base = rng.normal(size=(rows, 6)).astype(np.float32)
    m, p, mask = jfm.make_pe_matrix(FREQS)
    ref = np.asarray(jfm.fused_pre_combine_pe(
        jnp.asarray(base), jnp.asarray(latent), jnp.asarray(m),
        jnp.asarray(p), jnp.asarray(mask), *js[:8], tile=128))
    got = fm.pre_combine_pe(torch.from_numpy(base), torch.from_numpy(latent),
                            w, PositionalEncoding(6, 3, 1.5, True))
    assert got.dtype == F32 and got.shape == (rows, 64)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL * max(
        1.0, np.abs(ref).max()))


@pytest.mark.parametrize("d_in,d_latent,n_pre", [(78, 1792, 3), (6, 64, 1),
                                                 (78, 48, 3)])
def test_pre_combine_twin_matches_pallas_f32(rng, d_in, d_latent, n_pre):
    """The ring kernel's mode-3 twin (lin_in on given z-features, with a
    short last slice of w_in at d_in 78 and 6) against
    ``fused_pre_combine``."""
    js, w = _pair(d_in, d_latent, 64, n_pre)
    latent = rng.normal(size=(150, d_latent)).astype(np.float32)
    zf = rng.normal(size=(150, d_in)).astype(np.float32)
    ref = np.asarray(jfm.fused_pre_combine(
        jnp.asarray(zf), jnp.asarray(latent), *js[:8], tile=128))
    got = fm.pre_combine(torch.from_numpy(zf), torch.from_numpy(latent), w)
    assert got.dtype == F32 and got.shape == (150, 64)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL * max(
        1.0, np.abs(ref).max()))
