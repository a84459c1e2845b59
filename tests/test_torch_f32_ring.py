"""The f32 ring kernel's host side (csrc/field_mlp_f32.cu, every f32
mode): which kernel each mode and dtype takes, its feasibility and shared
memory, the walk of weight slices its warps issue, the fused route's
choice of its first kernel, and the twins it is held against on the card,
here against the JAX package's Pallas kernels (interpret mode on the
CPU).  The kernel itself is held against its twins in
tests/test_torch_kernels.py on the card."""

import dataclasses

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
          "narrow_z": (78, 64, 192), "h64": (42, 64, 64),
          # the conv encoder's 128-d latent at the flagship's hidden width
          "conv": (42, 128, 512)}


@pytest.mark.parametrize("dtype,want", [
    (F32, dict.fromkeys(fm.MODES, "cuda_core_ring")),
    (BF16, dict.fromkeys(fm.MODES, "tensor_core"))])
@pytest.mark.parametrize("mode", list(fm.MODES))
def test_variant_routing(mode, dtype, want):
    """bf16 takes the tensor cores in every mode, f32 the ring kernel in
    every mode; each variant names its own library, and the two field
    sources are built beside the latent gather's alone."""
    var = fm.variant(mode, dtype)
    assert var == want[mode]
    assert fm.LIBRARY[var] in fm.SOURCES
    assert fm.SOURCES[fm.LIBRARY[var]].name == {
        "tensor_core": "field_mlp_tc.cu",
        "cuda_core_ring": "field_mlp_f32.cu"}[var]
    assert sorted(p.name for p in fm.SOURCES.values()) == [
        "field_mlp_f32.cu", "field_mlp_tc.cu", "latent_gather.cu"]
    assert all(p.exists() for p in fm.SOURCES.values())


@pytest.mark.parametrize("widths", list(WIDTHS))
@pytest.mark.parametrize("mode", list(fm.MODES))
def test_fits_f32_ring_widths(mode, widths):
    """The ring kernel takes every width the tensor-core kernel takes:
    shared memory does not grow with d_latent (the YOLO 1792 fits), and
    z-features rounded up to 16 no wider than hidden (only 80 > 64
    fails; post_combine takes no z-features)."""
    d_in, d_latent, hidden = WIDTHS[widths]
    want = mode == "post_combine" or -(-d_in // 16) * 16 <= hidden
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
    # f32 full_pe runs on the ring kernel too, whose shared memory does
    # not grow with dL: it fits the YOLO width
    assert fm.fits(42, 512, 512, F32, "full_pe")
    assert fm.fits(42, 1792, 512, F32, "full_pe", 21)
    assert fm.fits(0, 0, 512, F32, "post_combine", 21)
    # lin_out: 1 to 256 columns (4 groups of 8 a warp), no wider than
    # hidden
    assert fm.fits(0, 0, 512, F32, "post_combine", 256)
    assert fm.fits(0, 0, 64, F32, "post_combine", 64)
    assert not fm.fits(0, 0, 512, F32, "post_combine", 257)
    assert not fm.fits(0, 0, 64, F32, "post_combine", 65)
    assert not fm.fits(42, 512, 512, F32, "full_pe", 0)
    # no lin_out before the combine: d_out does not matter there
    assert fm.fits(42, 512, 512, F32, "pre_combine_pe", 1000)


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


def _weights(d_in, d_latent, hidden, n_pre, seed=0, n_post=None, d_out=4):
    """n_post None: 5 blocks in all."""
    g = torch.Generator().manual_seed(seed)
    n_blocks = 5 if n_post is None else n_pre + n_post
    mlp = ResnetFC(d_in, d_out=d_out, n_blocks=n_blocks, d_latent=d_latent,
                   d_hidden=hidden, combine_layer=n_pre, generator=g)
    with torch.no_grad():
        for p in mlp.parameters():
            p.add_(torch.randn(p.shape, generator=g))
    return fm.stack_params(mlp, F32)


# lin_out stages at d_out 1, 4 (one stage of all rows), 21 (two)
OUT_STAGES = {0: 0, 1: 1, 4: 1, 21: 2}
# (widths, n_pre, n_post, d_out): pre_combine_pe / pre_combine (no post
# stage), then full_pe and post_combine (n_pre None: the walk starts at
# the post blocks) with n_post 0, 1, 2 and d_out 1, 4, 21
SCHEDULES = (
    [("nerf", 3, 0, 0), ("viewdirs", 3, 0, 0), ("yolo", 3, 0, 0),
     ("narrow", 1, 0, 0), ("narrow_z", 0, 0, 0), ("h64", 3, 0, 0)]
    + [({1: "narrow", 4: "nerf", 21: "yolo"}[d_out], n_pre, n_post, d_out)
       for n_pre in (3, None) for n_post in (0, 1, 2) for d_out in (1, 4, 21)]
    + [("h64", 0, 2, 21), ("h64", None, 1, 21), ("narrow_z", 1, 2, 4),
       ("conv", 3, 0, 0), ("conv", 3, 2, 4)])


@pytest.mark.parametrize("widths,n_pre,n_post,d_out", SCHEDULES)
def test_f32_schedule_round_trip(widths, n_pre, n_post, d_out):
    """The walk's slices, gathered in order from the stacked weights,
    rebuild w_in, wz, w0 and w1 (before the combine), w0p, w1p and w_out
    (after it) exactly; each block's latent slices cover its columns in
    order beside lin_z's slices; every slice fits a ring slot's 16 x H
    floats and splits into 16-byte pieces between the CTAs of a cluster;
    the count is the one the kernel's walk_stages computes."""
    d_in, d_latent, hidden = WIDTHS[widths]
    post_only = n_pre is None
    # before the combine alone (d_out 0): 5 blocks, the rest unwalked
    w = _weights(d_in, d_latent, hidden, 3 if post_only else n_pre,
                 n_post=n_post if d_out else None, d_out=d_out or 4)
    if post_only:
        d_in = d_latent = n_pre = 0
    sched = fm.f32_schedule(d_in, d_latent, hidden, n_pre, n_post, d_out)
    parts = {}
    for name, blk, first, rows, lat in sched:
        m = getattr(w, name) if blk is None else getattr(w, name)[blk]
        assert 0 < rows and first + rows <= m.shape[0]
        assert rows <= fm.F32_K_STEP or name == "w_out"
        assert rows * m.shape[1] <= fm.F32_K_STEP * hidden
        assert rows * m.shape[1] * 4 % (16 * fm.F32_CLUSTER) == 0
        assert (lat is not None) == (name == "wz")
        if lat is not None:
            assert lat == first and lat + fm.F32_K_STEP <= d_latent
        parts.setdefault((name, blk), []).append(m[first:first + rows])
    want = ([("w_in", None)] if d_in else []) \
        + [(n, b) for b in range(n_pre) for n in ("wz", "w0", "w1")] \
        + [(n, b) for b in range(n_post) for n in ("w0p", "w1p")] \
        + ([("w_out", None)] if d_out else [])
    assert list(parts) == want
    for name, b in want:
        m = getattr(w, name) if b is None else getattr(w, name)[b]
        assert torch.equal(torch.cat(parts[(name, b)]), m)
    assert len(sched) == (-(-d_in // 16) + n_pre * (d_latent + 2 * hidden)
                          // 16 + n_post * 2 * hidden // 16
                          + OUT_STAGES[d_out])
    # the order: lin_in, per pre block lin_z, fc_0, fc_1, per post block
    # fc_0, fc_1, lin_out
    order = [k for i, k in enumerate((s[0], s[1]) for s in sched)
             if i == 0 or k != (sched[i - 1][0], sched[i - 1][1])]
    assert order == want


@pytest.mark.parametrize("hidden", range(64, 513, 64))
def test_f32_out_rows_fewest_stages(hidden):
    """For every d_out the ring kernel takes: lin_out's rows a stage are a
    multiple of 8 and fit a slot's 16 x H floats, in as few stages as any
    such row count gives, and the stages are balanced (the last is the
    shortest, by less than 8 rows a stage)."""
    for d_out in range(1, min(fm.F32_MAX_OUT, hidden) + 1):
        rows = fm.f32_out_rows(hidden, d_out)
        assert rows % 8 == 0 and rows * d_out <= 16 * hidden
        widest = max(r for r in range(8, hidden + 1, 8)
                     if r * d_out <= 16 * hidden)
        n = -(-hidden // rows)
        assert n == -(-hidden // widest)
        assert 0 <= n * rows - hidden < 8 * n


@pytest.mark.parametrize("ns,first,fuse_f32", [(1, "full_pe", True),
                                               (3, "pre_combine_pe", True)])
def test_route_starts_at_its_first_kernel(ns, first, fuse_f32):
    """At the YOLO widths (1792-d latent) both routes fit in f32 and bf16:
    pre_combine_pe + post_combine (NS > 1) and the one-kernel full_pe
    (NS = 1; the ring kernel streams the latent in every f32 mode)."""
    mlp = ResnetFC(42, d_out=21, n_blocks=5, d_latent=1792, d_hidden=64,
                   combine_layer=3)
    assert PixelNeRF._first_kernel(mlp, ns, True) == first
    assert PixelNeRF._first_kernel(mlp, ns, False) == "pre_combine"
    for dtype, want in ((F32, fuse_f32), (BF16, True)):
        stub = SimpleNamespace(use_fused_mlp="auto", d_in=42,
                               compute_dtype=dtype, use_encoder=True,
                               global_encoder=None)
        assert PixelNeRF._can_fuse(stub, mlp, ns, first) is want


def test_route_without_post_blocks_starts_at_pre_combine_pe():
    mlp = ResnetFC(42, d_out=4, n_blocks=5, d_latent=64, d_hidden=64,
                   combine_layer=5)
    assert PixelNeRF._first_kernel(mlp, 1, True) == "pre_combine_pe"


# -- the f32 twins against the Pallas kernels --------------------------------

# f32: accumulation order only (tests/test_torch_field_mlp.py)
TOL = 2e-5
FREQS = tuple(1.5 * 2.0**i for i in range(6))


def _pair(d_in, d_latent, hidden, n_pre, seed=0, d_out=4):
    """The JAX package's stacked f32 weights and the port's, the same
    numbers (made with numpy)."""
    w = _weights(d_in, d_latent, hidden, n_pre, seed, d_out=d_out)
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


@pytest.mark.parametrize("d_latent,n_pre,d_out,rows", [(1792, 3, 21, 150),
                                                       (64, 1, 21, 37),
                                                       (48, 4, 4, 129)])
def test_full_pe_twin_matches_pallas_f32(rng, d_latent, n_pre, d_out, rows):
    """The ring kernel's mode-0 twin at the YOLO widths (1792-d latent, 21
    outputs: f32 full_pe now fits them) and with four post blocks or one,
    on ragged rows, against ``fused_full_pe``."""
    js, w = _pair(42, d_latent, 64, n_pre, d_out=d_out)
    latent = rng.normal(size=(rows, d_latent)).astype(np.float32)
    base = rng.normal(size=(rows, 6)).astype(np.float32)
    m, p, mask = jfm.make_pe_matrix(FREQS)
    ref = np.asarray(jfm.fused_full_pe(
        jnp.asarray(base), jnp.asarray(latent), jnp.asarray(m),
        jnp.asarray(p), jnp.asarray(mask), *js, tile=128))
    got = fm.full_pe(torch.from_numpy(base), torch.from_numpy(latent), w,
                     PositionalEncoding(6, 3, 1.5, True))
    assert got.dtype == F32 and got.shape == (rows, d_out)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL * max(
        1.0, np.abs(ref).max()))


@pytest.mark.parametrize("n_pre,d_out,rows", [(3, 21, 150), (4, 21, 33),
                                              (3, 1, 129)])
def test_post_combine_twin_matches_pallas_f32(rng, n_pre, d_out, rows):
    """The ring kernel's mode-2 twin with the YOLO head (21 outputs, two
    lin_out stages on the card) and a 1-wide one, behind two post blocks
    or one, against ``fused_post_combine``."""
    js, w = _pair(42, 64, 64, n_pre, d_out=d_out)
    h = rng.normal(size=(rows, 64)).astype(np.float32)
    ref = np.asarray(jfm.fused_post_combine(jnp.asarray(h), *js[8:],
                                            tile=128))
    got = fm.post_combine(torch.from_numpy(h), w)
    assert got.dtype == F32 and got.shape == (rows, d_out)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL * max(
        1.0, np.abs(ref).max()))


def test_post_combine_without_post_blocks_is_lin_out(rng):
    """post_combine with no post block (the NS=1 route at combine_layer
    >= n_blocks): lin_out on relu(h) alone, the ring kernel's shortest
    walk (lin_out's stages only)."""
    w = _weights(42, 64, 64, 5, n_post=0, d_out=21)
    assert w.w0p.shape == (0, 64, 64)
    assert fm.f32_schedule(0, 0, 64, 0, 0, 21) == [
        ("w_out", None, 0, 32, None), ("w_out", None, 32, 32, None)]
    h = torch.from_numpy(rng.normal(size=(40, 64)).astype(np.float32))
    got = fm.post_combine(h, w)
    ref = torch.relu(h).double() @ w.w_out.double() + w.b_out.double()
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=TOL * max(
        1.0, ref.abs().max().item()))
