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
# the NeRF, viewdirs and YOLO flagships, the conv encoder's 128-d latent
# (with and without the viewdirs' PE), narrow test widths
WIDTHS = [(42, 512, 512), (78, 512, 512), (42, 1792, 512), (42, 128, 512),
          (78, 128, 512), (42, 48, 128), (78, 64, 128), (6, 64, 64)]


def _unpack_layer(flat, K, H):
    """Inverse of ``field_mlp._pack_layer``."""
    return flat.reshape(K // 16, H // 8, 2, 8, 8).permute(0, 2, 4, 1, 3) \
        .reshape(K, H)


def unpack_tc(packed, d_in, d_latent, hidden, n_pre):
    """Inverse of ``field_mlp.pack_tc`` before the combine: (w_in, wz, w0,
    w1) as ``stack_params`` gives them."""
    dz = -(-d_in // fm.TC_K_STEP) * fm.TC_K_STEP
    sizes = [dz * hidden] + [d_latent * hidden, hidden * hidden,
                             hidden * hidden] * n_pre
    parts = list(torch.split(packed[:sum(sizes)], sizes))
    blocks = [[_unpack_layer(parts[1 + 3 * i + j], K, hidden)
               for j, K in enumerate((d_latent, hidden, hidden))]
              for i in range(n_pre)]
    stacks = [torch.stack([b[j] for b in blocks]) for j in range(3)]
    return (_unpack_layer(parts[0], dz, hidden)[:d_in], *stacks)


def unpack_tc_post(packed, w):
    """Inverse of ``field_mlp.pack_tc`` after the combine, from the stage
    ``tc_stages(w)[0]`` on: (w0p, w1p, w_out padded to Nout columns)."""
    H = w.hidden
    pre, post, out = fm.tc_stages(w)
    stage = fm.TC_K_STEP * H
    body = packed[pre * stage:]
    assert body.numel() == (post + out) * stage
    layers = [_unpack_layer(x, H, H)
              for x in body[:post * stage].reshape(-1, H * H)]
    w0p = torch.stack(layers[0::2]) if layers else w.w0p
    w1p = torch.stack(layers[1::2]) if layers else w.w1p
    nout = fm.tc_out_width(w.w_out.shape[1])
    per = H // nout
    slices = body[post * stage:].reshape(out, stage)[:, :per * 16 * nout] \
        .reshape(out * per, 16 * nout)[:H // 16]
    return w0p, w1p, _unpack_layer(slices.reshape(-1), H, nout)


def _weights(d_in, d_latent, hidden, dtype=torch.bfloat16, seed=0, d_out=4,
             combine_layer=3):
    g = torch.Generator().manual_seed(seed)
    mlp = ResnetFC(d_in, d_out=d_out, n_blocks=5, d_latent=d_latent,
                   d_hidden=hidden, combine_layer=combine_layer, dtype=dtype,
                   generator=g)
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
    # then 2 post blocks and lin_out (d_out 4: one stage)
    assert fm.tc_stages(w) == (stages, 2 * 2 * hidden // 16, 1)
    assert packed.numel() == (stages + 4 * hidden // 16 + 1) \
        * fm.TC_K_STEP * hidden
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
    # the f32 ring kernel keeps its own limits: at dL 1792 f32 full_pe and
    # pre_combine_pe fit (field_mlp_f32.cu streams the latent in every
    # mode); its lin_out takes any d_out up to 256, the tensor-core one a
    # width of tc_out_width (both no wider than hidden)
    assert fm.fits(42, 1792, 512, torch.float32, "full_pe")
    assert fm.fits(42, 1792, 512, torch.float32, "pre_combine_pe")
    # (at hidden 192, d_out 150 rounds up to 256 > 192 on the tensor
    # cores)
    assert fm.fits(0, 0, 192, torch.float32, "post_combine", 150)
    assert not fm.fits(0, 0, 192, bf16, "post_combine", 150)
    assert not fm.fits(0, 0, 512, torch.float32, "post_combine", 300)


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
    """Every bf16 mode takes the tensor-core kernel, every f32 mode the
    CUDA-core ring kernel."""
    want = "tensor_core" if dtype == torch.bfloat16 else "cuda_core_ring"
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


# -- after the combine: post blocks and lin_out (full_pe, post_combine) ------

# (d_in, d_latent, hidden) x d_out: NeRF (4) and YOLO (21) heads at every
# width of WIDTHS
@pytest.mark.parametrize("d_out", [4, 21])
@pytest.mark.parametrize("d_in,d_latent,hidden", WIDTHS)
def test_unpacked_post_weights_are_stack_params(d_in, d_latent, hidden,
                                                d_out):
    """The stream after the pre blocks holds w0p, w1p and w_out (zero
    columns up to Nout: 8 for d_out 4, 24 for 21) in whole ring stages."""
    _, w = _weights(d_in, d_latent, hidden, d_out=d_out)
    packed = fm.pack_tc(w)
    nout = fm.tc_out_width(d_out)
    assert nout == {4: 8, 21: 24}[d_out]
    pre, post, out = fm.tc_stages(w)
    assert post == 2 * 2 * hidden // 16
    assert out == fm.tc_out_stages(hidden, nout) == -(-(hidden // 16)
                                                      // (hidden // nout))
    assert packed.numel() == (pre + post + out) * 16 * hidden
    w0p, w1p, w_out = unpack_tc_post(packed, w)
    assert torch.equal(w0p, w.w0p) and torch.equal(w1p, w.w1p)
    assert torch.equal(w_out[:, :d_out], w.w_out)
    assert not w_out[:, d_out:].any()


@pytest.mark.parametrize("hidden,d_out,stages", [
    (512, 4, 1), (512, 21, 2), (512, 256, 16), (128, 21, 2), (64, 4, 1),
    (64, 64, 4)])
def test_lin_out_stage_layout(hidden, d_out, stages):
    """Element (16 j + 8 c + e, 8 q + r) of w_out (K slice j of 16 x Nout)
    sits in lin_out's stage j // (H // Nout) at (j % (H // Nout)) * 16 *
    Nout + q * 128 + c * 64 + r * 8 + e; the rest of each stage is zero.
    At H = 512 NeRF's lin_out is one stage, YOLO's two."""
    _, w = _weights(42, 48, hidden, d_out=d_out)
    packed = fm.pack_tc(w)
    pre, post, out = fm.tc_stages(w)
    assert out == stages
    stage = 16 * hidden
    lo = packed[(pre + post) * stage:]
    assert lo.numel() == stages * stage
    nout, per = fm.tc_out_width(d_out), hidden // fm.tc_out_width(d_out)
    rng = np.random.default_rng(0)
    for _ in range(60):
        j, c, e = rng.integers(0, hidden // 16), rng.integers(0, 2), \
            rng.integers(0, 8)
        q, r = rng.integers(0, nout // 8), rng.integers(0, 8)
        k, n = 16 * j + 8 * c + e, 8 * q + r
        at = (j // per) * stage + (j % per) * 16 * nout + q * 128 + c * 64 \
            + r * 8 + e
        want = w.w_out[k, n] if n < d_out else 0
        assert lo[at] == want
    used = min(per, hidden // 16) * 16 * nout
    assert not lo.reshape(stages, stage)[:, used:].any()


@pytest.mark.parametrize("combine_layer", [1, 3, 5])
@pytest.mark.parametrize("d_in,d_latent,hidden", [(42, 512, 512),
                                                  (42, 1792, 512),
                                                  (78, 40, 64)])
def test_post_combine_stage_offset(d_in, d_latent, hidden, combine_layer):
    """post_combine's walk starts at stage tc_stages(w)[0]: lin_in (rows
    padded to 16) and n_pre x (lin_z rows padded to 16, fc_0, fc_1).  There
    the first post block's fc_0 begins, or lin_out when there is none."""
    _, w = _weights(d_in, d_latent, hidden, combine_layer=combine_layer)
    packed = fm.pack_tc(w)
    pre = fm.tc_stages(w)[0]
    n_pre = min(combine_layer, 5)
    assert pre == (-(-d_in // 16) + n_pre * (-(-d_latent // 16)
                                             + 2 * hidden // 16))
    at = packed[pre * 16 * hidden:]
    if n_pre < 5:
        assert torch.equal(at[:hidden * hidden], fm._pack_layer(w.w0p[0]))
    else:
        assert fm.tc_stages(w)[1] == 0
        assert torch.equal(unpack_tc_post(packed, w)[2][:, :4], w.w_out)


@pytest.mark.parametrize("d_out", [4, 21, 256, 257])
@pytest.mark.parametrize("mode", ["full_pe", "post_combine"])
def test_fits_lin_out_modes(mode, d_out):
    """Modes 0 and 2 in bf16 take every d_out with a lin_out width (up to
    256, one wgmma N) no wider than hidden; post_combine has no
    z-feature or latent condition; the shared memory is mode 1's."""
    bf16 = torch.bfloat16
    want = d_out <= 256
    assert fm.fits(42, 512, 512, bf16, mode, d_out) is want
    assert fm.fits(42, 1792, 512, bf16, mode, d_out) is want
    # Nout no wider than hidden: 24 fits at 64, 256 only at 256 and up
    assert fm.fits(42, 64, 64, bf16, mode, d_out) is (d_out <= 64)
    # post_combine ignores d_in and d_latent; full_pe keeps their limits
    assert fm.fits(0, 0, 512, bf16, mode, d_out) is (
        want and mode == "post_combine")
    assert fm.fits(520, 40, 512, bf16, mode, d_out) is (
        want and mode == "post_combine")
    assert fm.smem_bytes_tc(512) == 226384 <= fm.SMEM_LIMIT
    # f32 runs on the CUDA-core ring kernel, whose lin_out takes up to
    # 256 columns too
    assert fm.fits(42, 512, 512, torch.float32, mode, d_out) is want


@pytest.mark.parametrize("d_out", [4, 21])
@pytest.mark.parametrize("mode", ["full_pe", "post_combine"])
def test_lin_out_twin_on_unpacked_weights(mode, d_out):
    """The plain twin fed w0p, w1p and w_out unpacked from the stream
    equals the twin on ``stack_params``'s."""
    d_in, d_latent, hidden = 42, 48, 128
    _, w = _weights(d_in, d_latent, hidden, d_out=d_out)
    w0p, w1p, w_out = unpack_tc_post(fm.pack_tc(w), w)
    wu = dataclasses.replace(w, w0p=w0p, w1p=w1p,
                             w_out=w_out[:, :d_out].contiguous())
    g = torch.Generator().manual_seed(1)
    rows = 37
    lat = torch.randn((rows, d_latent), generator=g).bfloat16()
    base = torch.rand((rows, 6), generator=g) * 2 - 1
    code = PositionalEncoding(6, 3, 1.5, True)
    if mode == "full_pe":
        args, argsu = (base, lat, w, code), (base, lat, wu, code)
    else:
        h = fm.pre_combine_pe_plain(base, lat, w, code)
        args, argsu = (h, w), (h, wu)
    twin = getattr(fm, mode + "_plain")
    got = twin(*argsu)
    assert got.shape == (rows, d_out) and got.dtype == torch.float32
    assert torch.equal(got, twin(*args))


def test_replace_drops_the_packed_stream():
    """``dataclasses.replace`` of StackedWeights (as the card tests cut
    blocks) does not carry a stream packed for the old weights."""
    _, w = _weights(42, 64, 128)
    fm.tc_weights(w)
    cut = dataclasses.replace(w, w0p=w.w0p[:1].contiguous(),
                              b0p=w.b0p[:1].contiguous(),
                              w1p=w.w1p[:1].contiguous(),
                              b1p=w.b1p[:1].contiguous())
    assert cut.tc is None
    assert fm.tc_weights(cut).numel() == sum(fm.tc_stages(cut)) * 16 * 128


@pytest.mark.parametrize("d_out,want", [(4, True), (21, True), (256, True),
                                        (300, False)])
def test_can_fuse_needs_a_lin_out_width(d_out, want):
    """A route ends in post_combine (or full_pe), so the model fuses only
    when the kernel takes its lin_out: a tensor-core width in bf16, at
    most 256 columns in f32 (the ring kernel)."""
    from types import SimpleNamespace

    from pixelnerf_yolo_torch.models.pixelnerf import PixelNeRF

    mlp = ResnetFC(42, d_out=d_out, n_blocks=5, d_latent=64, d_hidden=512,
                   combine_layer=3, dtype=torch.bfloat16,
                   generator=torch.Generator().manual_seed(0))
    for dtype, expect in ((torch.bfloat16, want), (torch.float32, want)):
        model = SimpleNamespace(use_fused_mlp="auto", d_in=42,
                                compute_dtype=dtype, use_encoder=True,
                                global_encoder=None)
        for ns, mode in ((1, "full_pe"), (2, "full_pe"), (2, "pre_combine")):
            assert PixelNeRF._can_fuse(model, mlp, ns, mode) is expect
