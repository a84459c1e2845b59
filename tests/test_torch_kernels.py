"""The port's CUDA field-MLP kernels against their plain twins.

This file imports neither jax nor the JAX package, so that it also runs on
a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

The tests marked ``cuda`` need an NVIDIA GPU and skip elsewhere; the rest
check the wrappers' CPU dispatch and argument checks.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pixelnerf_yolo_torch.nn.code import PositionalEncoding
from pixelnerf_yolo_torch.nn.resnetfc import ResnetFC
from pixelnerf_yolo_torch.ops import field_mlp as fm

KINDS = ("full_pe", "pre_combine_pe", "post_combine")
# kernel vs twin, relative to max|twin|: f32 differs in summation order
# only; bf16 can flip one bf16 rounding, which the later layers carry
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _mlp(hidden, d_latent, dtype, seed=0, combine_layer=3, d_in=42, d_out=4):
    g = torch.Generator().manual_seed(seed)
    mlp = ResnetFC(d_in, d_out=d_out, n_blocks=5, d_latent=d_latent,
                   d_hidden=hidden, combine_layer=combine_layer, dtype=dtype,
                   generator=g)
    with torch.no_grad():
        for name, p in mlp.named_parameters():
            if ".fc_1." in name or name.endswith("bias"):
                p.add_(torch.randn(p.shape, generator=g) * 0.02)
    return mlp


def _inputs(rows, d_latent, dtype, device, seed=1):
    g = torch.Generator().manual_seed(seed)
    base = torch.rand((rows, 6), generator=g) * 2 - 1
    base[:, 3:] /= base[:, 3:].norm(dim=-1, keepdim=True)
    lat = torch.randn((rows, d_latent), generator=g).to(dtype)
    return base.to(device), lat.to(device)


def _run(kind, w, base, lat, code, kernel: bool):
    fn = getattr(fm, kind if kernel else kind + "_plain")
    if kind == "post_combine":
        h = fm.pre_combine_pe_plain(base, lat, w, code).contiguous()
        return fn(h, w)
    return fn(base, lat, w, code)


@pytest.mark.parametrize("kind", KINDS)
def test_cpu_tensors_take_the_twin(kind):
    code = PositionalEncoding(6, 3, 1.5, True)
    w = fm.stack_params(_mlp(64, 64, torch.float32), torch.float32)
    base, lat = _inputs(33, 64, torch.float32, "cpu")
    fm.reset_launches()
    with torch.no_grad():
        got = _run(kind, w, base, lat, code, kernel=True)
        ref = _run(kind, w, base, lat, code, kernel=False)
    assert torch.equal(got, ref)
    assert sum(fm.launches.values()) == 0


def test_stacked_weight_layout():
    mlp = _mlp(64, 32, torch.float32)
    w = fm.stack_params(mlp, torch.bfloat16)
    assert w.w_in.shape == (42, 64) and w.w_in.dtype == torch.bfloat16
    assert w.wz.shape == (3, 32, 64) and w.bz.dtype == torch.float32
    assert w.w0p.shape == (2, 64, 64) and w.w_out.shape == (64, 4)
    torch.testing.assert_close(w.w1p[1].float(),
                               mlp.blocks[4].fc_1.weight.t().bfloat16().float())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden,d_latent,rows", [(512, 512, 1037),
                                                  (64, 64, 100), (128, 48, 5)])
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matches_twin(cuda_device, kind, dtype, hidden, d_latent, rows):
    code = PositionalEncoding(6, 3, 1.5, True).to(cuda_device)
    w = fm.stack_params(_mlp(hidden, d_latent, dtype).to(cuda_device), dtype)
    base, lat = _inputs(rows, d_latent, dtype, cuda_device)
    fm.reset_launches()
    with torch.no_grad():
        got = _run(kind, w, base, lat, code, kernel=True)
        ref = _run(kind, w, base, lat, code, kernel=False)
    torch.cuda.synchronize()
    assert fm.launches[kind] == 1
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert bool(torch.isfinite(got).all())
    scale = max(1.0, ref.float().abs().max().item())
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype] * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_without_post_blocks(cuda_device, dtype):
    """combine_layer == n_blocks at NS=1: pre_combine_pe, then post_combine
    with no block (lin_out alone)."""
    code = PositionalEncoding(6, 3, 1.5, True).to(cuda_device)
    mlp = _mlp(64, 64, dtype, combine_layer=5).to(cuda_device)
    base, lat = _inputs(100, 64, dtype, cuda_device)
    fm.reset_launches()
    with torch.no_grad():
        got = fm.fused_pe_forward(mlp, lat, base, 1, 100, dtype, code)
        w = fm.stack_params(mlp, dtype)
        ref = fm.post_combine_plain(fm.pre_combine_pe_plain(base, lat, w,
                                                            code), w)
    torch.cuda.synchronize()
    assert fm.launches == {"full_pe": 0, "pre_combine_pe": 1,
                           "post_combine": 1, "pre_combine": 0}
    scale = max(1.0, ref.abs().max().item())
    assert (got - ref).abs().max().item() <= TOL[dtype] * scale


def _zfeat(rows, d_in, dtype, device, seed=2):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((rows, d_in), generator=g).to(dtype).to(device)


def test_pre_combine_cpu_tensors_take_the_twin():
    w = fm.stack_params(_mlp(128, 64, torch.float32, d_in=78), torch.float32)
    zf = _zfeat(33, 78, torch.float32, "cpu")
    _, lat = _inputs(33, 64, torch.float32, "cpu")
    fm.reset_launches()
    got = fm.pre_combine(zf, lat, w)
    assert torch.equal(got, fm.pre_combine_plain(zf, lat, w))
    assert sum(fm.launches.values()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden,d_in,rows", [(512, 78, 1037), (128, 78, 100),
                                              (64, 6, 5)])
def test_pre_combine_kernel_matches_twin(cuda_device, dtype, hidden, d_in,
                                         rows):
    """Mode 3: lin_in on given z-features (the use_code_viewdirs width 78,
    and 6), then the pre-combine blocks."""
    w = fm.stack_params(_mlp(hidden, 512, dtype, d_in=d_in).to(cuda_device),
                        dtype)
    zf = _zfeat(rows, d_in, dtype, cuda_device)
    _, lat = _inputs(rows, 512, dtype, cuda_device)
    fm.reset_launches()
    with torch.no_grad():
        got = fm.pre_combine(zf, lat, w)
        ref = fm.pre_combine_plain(zf, lat, w)
    torch.cuda.synchronize()
    assert fm.launches["pre_combine"] == 1
    assert got.dtype == ref.dtype == dtype and got.shape == (rows, hidden)
    scale = max(1.0, ref.float().abs().max().item())
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype] * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["pre_combine_pe", "post_combine"])
def test_yolo_widths_match_twin(cuda_device, kind):
    """Modes 1 and 2 at the YOLO widths, bf16: a 1792-d latent (the
    32 x 1792 latent tile takes 114,688 B of shared memory) and lin_out
    with 21 columns (7 x 3 anchors)."""
    dtype = torch.bfloat16
    code = PositionalEncoding(6, 3, 1.5, True).to(cuda_device)
    w = fm.stack_params(_mlp(512, 1792, dtype, d_out=21).to(cuda_device),
                        dtype)
    base, lat = _inputs(1037, 1792, dtype, cuda_device)
    fm.reset_launches()
    with torch.no_grad():
        got = _run(kind, w, base, lat, code, kernel=True)
        ref = _run(kind, w, base, lat, code, kernel=False)
    torch.cuda.synchronize()
    assert fm.launches[kind] == 1
    assert got.shape == ref.shape
    scale = max(1.0, ref.float().abs().max().item())
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype] * scale, (err, scale)


@pytest.mark.cuda
def test_kernel_rejects_bad_arguments(cuda_device):
    code = PositionalEncoding(6, 3, 1.5, True).to(cuda_device)
    w = fm.stack_params(_mlp(64, 64, torch.float32).to(cuda_device),
                        torch.float32)
    base, lat = _inputs(16, 64, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        fm.full_pe(base, lat.bfloat16(), w, code)
    with pytest.raises(ValueError, match="contiguous"):
        fm.full_pe(base, lat.t().contiguous().t(), w, code)
    with pytest.raises(ValueError, match="shape"):
        fm.full_pe(base[:8], lat, w, code)
    with pytest.raises(ValueError, match="zfeat"):
        fm.pre_combine(base, lat, w)  # 6 columns, w_in takes 42


# -- the tensor-core variant (every bf16 mode) --------------------------------

# (mode, d_in, d_latent, hidden): NeRF, use_code_viewdirs and YOLO widths,
# then narrow ones (m64n32k16 in place of m64n256k16; 192 an odd count of
# 32-column chunks per warpgroup); full_pe and post_combine at the NeRF
# widths, narrow ones and H = 64 (lin_out's 24 columns in 2 stages),
# post_combine also behind the YOLO pre blocks (its walk starts further in)
TC_WIDTHS = {
    "nerf": ("pre_combine_pe", 42, 512, 512),
    "viewdirs": ("pre_combine", 78, 512, 512),
    "yolo": ("pre_combine_pe", 42, 1792, 512),
    "narrow": ("pre_combine_pe", 42, 48, 128),
    "narrow_z": ("pre_combine", 78, 64, 192),
    "h64": ("pre_combine_pe", 42, 64, 64),
    "full_nerf": ("full_pe", 42, 512, 512),
    "full_narrow": ("full_pe", 42, 48, 128),
    "full_h64": ("full_pe", 42, 64, 64),
    "post_nerf": ("post_combine", 42, 512, 512),
    "post_yolo": ("post_combine", 42, 1792, 512),
    "post_narrow": ("post_combine", 42, 48, 192),
}
TC_ROWS_CHECKED = (1, 63, 64, 65, 1037, 40013)
# (widths, n_pre, n_post, d_out, rows): modes 1 and 3 with n_pre 0, 1, 3;
# modes 0 and 2 also with n_post 0, 1, 2 and d_out 4 (NeRF), 21 (YOLO)
TC_CASES = [
    (wid, n_pre, n_post, d_out, rows)
    for wid, (mode, *_) in TC_WIDTHS.items()
    for n_pre in (0, 1, 3)
    for n_post in ((0, 1, 2) if mode in ("full_pe", "post_combine") else (2,))
    for d_out in ((4, 21) if mode in ("full_pe", "post_combine") else (4,))
    for rows in TC_ROWS_CHECKED
]


def _tc_case(device, widths, n_pre, rows, n_post=2, d_out=4,
             dtype=torch.bfloat16):
    """widths: a key of TC_WIDTHS or a (mode, d_in, d_latent, hidden)."""
    mode, d_in, d_latent, hidden = TC_WIDTHS.get(widths, widths)
    w = fm.stack_params(_mlp(hidden, d_latent, dtype, d_in=d_in,
                             d_out=d_out).to(device), dtype)
    # the first n_pre pre blocks (n_pre = 0: lin_in alone) and the first
    # n_post post blocks (n_post = 0: lin_out alone)
    cut = {k: getattr(w, k)[:n_pre].contiguous()
           for k in ("wz", "bz", "w0", "b0", "w1", "b1")}
    cut.update({k: getattr(w, k)[:n_post].contiguous()
                for k in ("w0p", "b0p", "w1p", "b1p")})
    w = dataclasses.replace(w, **cut)
    base, lat = _inputs(rows, d_latent, dtype, device)
    code = PositionalEncoding(6, 3, 1.5, True).to(device)
    if mode in ("pre_combine_pe", "full_pe"):
        args = (base, lat, w, code)
    elif mode == "pre_combine":
        args = (_zfeat(rows, d_in, dtype, device), lat, w)
    else:
        args = (fm.pre_combine_pe_plain(base, lat, w, code).contiguous(), w)
    return mode, args


@pytest.mark.cuda
@pytest.mark.parametrize("widths,n_pre,n_post,d_out,rows", TC_CASES)
def test_tc_kernel_matches_twin(cuda_device, widths, n_pre, n_post, d_out,
                                rows):
    """The wgmma kernel against its twin: lin_in alone, one and three pre
    blocks; lin_out alone, one and two post blocks; ragged rows (1,037
    rows are 17 row tiles: a cluster with a CTA past the last row)."""
    mode, args = _tc_case(cuda_device, widths, n_pre, rows, n_post, d_out)
    assert fm.variant(mode, torch.bfloat16) == "tensor_core"
    fm.reset_launches()
    with torch.no_grad():
        got = getattr(fm, mode)(*args)
        ref = getattr(fm, mode + "_plain")(*args)
    torch.cuda.synchronize()
    assert fm.launches[mode] == 1 and sum(fm.launches.values()) == 1
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert bool(torch.isfinite(got).all())
    scale = max(1.0, ref.float().abs().max().item())
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= TOL[torch.bfloat16] * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [512, 256])
@pytest.mark.parametrize("d_out", [1, 8, 9, 32, 33, 64, 100, 200, 256])
@pytest.mark.parametrize("mode", ["full_pe", "post_combine"])
def test_tc_lin_out_widths(cuda_device, mode, d_out, hidden):
    """Every lin_out width of the tensor-core kernel (Nout 8 to 256: the
    two warpgroups split its 8-column groups, one of them empty at Nout 8)
    against the twin."""
    _, args = _tc_case(cuda_device, (mode, 42, 64, hidden), 1, 1037,
                       n_post=1, d_out=d_out)
    fm.reset_launches()
    with torch.no_grad():
        got = getattr(fm, mode)(*args)
        ref = getattr(fm, mode + "_plain")(*args)
    torch.cuda.synchronize()
    assert fm.launches[mode] == 1
    assert got.shape == ref.shape == (1037, d_out)
    scale = max(1.0, ref.abs().max().item())
    err = (got - ref).abs().max().item()
    assert err <= TOL[torch.bfloat16] * scale, (err, scale)


@pytest.mark.cuda
def test_tc_kernel_raises_on_unaligned_h(cuda_device):
    mode, (h, w) = _tc_case(cuda_device, "post_narrow", 1, 9)
    flat = torch.empty(h.numel() + 1, dtype=h.dtype, device=cuda_device)
    shifted = flat[1:].view(h.shape)
    with pytest.raises(ValueError, match="16-byte"):
        fm.post_combine(shifted, w)


@pytest.mark.cuda
def test_tc_kernel_raises_on_unaligned_latent(cuda_device):
    mode, (base, lat, w, code) = _tc_case(cuda_device, "h64", 1, 9)
    flat = torch.empty(lat.numel() + 1, dtype=lat.dtype, device=cuda_device)
    shifted = flat[1:].view(lat.shape)
    with pytest.raises(ValueError, match="16-byte"):
        fm.pre_combine_pe(base, shifted, w, code)


# -- the f32 ring kernel (field_mlp_f32.cu: every f32 mode) ------------------

# (mode, d_in, d_latent, hidden): NeRF, use_code_viewdirs and YOLO widths,
# then narrow ones (H / 64 columns a thread: 2 at 128, 3 at 192, 1 at 64,
# 4 at 256) and z-features of 6 (one short slice of w_in)
RING_WIDTHS = {
    "nerf": ("pre_combine_pe", 42, 512, 512),
    "viewdirs": ("pre_combine", 78, 512, 512),
    "yolo": ("pre_combine_pe", 42, 1792, 512),
    "narrow": ("pre_combine_pe", 42, 48, 128),
    "narrow_z": ("pre_combine", 78, 64, 192),
    "h64": ("pre_combine_pe", 42, 64, 64),
    "z6": ("pre_combine", 6, 32, 256),
}
# one CTA's 32 rows and its edges, a cluster's 64 and its edges, 1,037
# rows (33 row tiles: the last cluster's second CTA lies past the last
# row) and 40,013
RING_ROWS = (1, 31, 32, 33, 63, 64, 65, 1037, 40013)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", RING_ROWS)
@pytest.mark.parametrize("n_pre", (0, 1, 3))
@pytest.mark.parametrize("widths", list(RING_WIDTHS))
def test_f32_ring_kernel_matches_twin(cuda_device, widths, n_pre, rows):
    """The f32 ring kernel against its twin: lin_in alone, one and three
    pre blocks, ragged rows, within 1e-4 x max|twin|."""
    mode, args = _tc_case(cuda_device, RING_WIDTHS[widths], n_pre, rows,
                          dtype=torch.float32)
    assert fm.variant(mode, torch.float32) == "cuda_core_ring"
    fm.reset_launches()
    with torch.no_grad():
        got = getattr(fm, mode)(*args)
        ref = getattr(fm, mode + "_plain")(*args)
    torch.cuda.synchronize()
    assert fm.launches[mode] == 1 and sum(fm.launches.values()) == 1
    assert fm.variant_launches == {f"{mode}/cuda_core_ring": 1}
    assert got.dtype == ref.dtype == torch.float32
    assert got.shape == ref.shape == (rows, RING_WIDTHS[widths][3])
    assert bool(torch.isfinite(got).all())
    err = (got - ref).abs().max().item()
    assert err <= TOL[torch.float32] * ref.abs().max().item(), err


# after the combine (modes 0 and 2): (mode, d_in, d_latent, hidden) at the
# NeRF and YOLO widths (full_pe at dL 1792 too) and narrow ones (H 64, 128,
# 192: 1, 2 and 3 columns a thread)
RING_POST_WIDTHS = {
    "full_nerf": ("full_pe", 42, 512, 512),
    "full_yolo": ("full_pe", 42, 1792, 512),
    "full_narrow": ("full_pe", 42, 48, 128),
    "full_h64": ("full_pe", 42, 64, 64),
    "post_nerf": ("post_combine", 42, 512, 512),
    "post_yolo": ("post_combine", 42, 1792, 512),
    "post_narrow": ("post_combine", 42, 48, 192),
}
# (widths, n_pre, n_post, d_out, rows): lin_in alone, one and three pre
# blocks (full_pe; post_combine's h comes from three), lin_out alone, one
# and two post blocks, lin_out 1, 4 (NeRF), 21 (YOLO: two lin_out stages)
# and 64 wide; every row count of RING_ROWS with the two flagship heads
# behind two post blocks, two row counts otherwise
RING_POST_CASES = [
    (wid, n_pre, n_post, d_out, rows)
    for wid, (mode, *_) in RING_POST_WIDTHS.items()
    for n_pre in ((0, 1, 3) if mode == "full_pe" else (3,))
    for n_post in (0, 1, 2)
    for d_out in (1, 4, 21, 64)
    for rows in (RING_ROWS if n_post == 2 and d_out in (4, 21)
                 else (33, 1037))
]


@pytest.mark.cuda
@pytest.mark.parametrize("widths,n_pre,n_post,d_out,rows", RING_POST_CASES)
def test_f32_ring_post_matches_twin(cuda_device, widths, n_pre, n_post,
                                    d_out, rows):
    """full_pe and post_combine on the ring kernel against their twins
    within 1e-4 x max|twin|: the post blocks' stages after the pre blocks'
    (or first), lin_out's one or more stages, ragged rows."""
    mode, args = _tc_case(cuda_device, RING_POST_WIDTHS[widths], n_pre, rows,
                          n_post, d_out, dtype=torch.float32)
    assert fm.variant(mode, torch.float32) == "cuda_core_ring"
    fm.reset_launches()
    with torch.no_grad():
        got = getattr(fm, mode)(*args)
        ref = getattr(fm, mode + "_plain")(*args)
    torch.cuda.synchronize()
    assert fm.variant_launches == {f"{mode}/cuda_core_ring": 1}
    assert got.dtype == ref.dtype == torch.float32
    assert got.shape == ref.shape == (rows, d_out)
    assert bool(torch.isfinite(got).all())
    err = (got - ref).abs().max().item()
    assert err <= TOL[torch.float32] * ref.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [512, 256])
@pytest.mark.parametrize("d_out", [2, 8, 33, 100, 200, 256])
@pytest.mark.parametrize("mode", ["full_pe", "post_combine"])
def test_f32_ring_lin_out_widths(cuda_device, mode, d_out, hidden):
    """lin_out up to the ring kernel's limit (256 columns: 4 groups of 8
    a warp; 16 stages of 32 rows at H = 512) against the twin."""
    _, args = _tc_case(cuda_device, (mode, 42, 64, hidden), 1, 1037,
                       n_post=1, d_out=d_out, dtype=torch.float32)
    fm.reset_launches()
    with torch.no_grad():
        got = getattr(fm, mode)(*args)
        ref = getattr(fm, mode + "_plain")(*args)
    torch.cuda.synchronize()
    assert fm.launches[mode] == 1
    assert got.shape == ref.shape == (1037, d_out)
    err = (got - ref).abs().max().item()
    assert err <= TOL[torch.float32] * ref.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("mode,what", [
    (mode, what) for mode in ("full_pe", "post_combine")
    for what in ("w0p", "w1p", "w_out") + (("h",) if mode[0] == "p" else ())])
def test_f32_ring_post_raises_on_unaligned(cuda_device, mode, what):
    """The post stacks and w_out (bulk copies) and h (16-byte loads) must
    be 16-byte aligned: a tensor 4 bytes off raises, and nothing launches."""
    _, args = _tc_case(cuda_device, (mode, 42, 64, 64), 1, 9, n_post=1,
                       d_out=21, dtype=torch.float32)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = flat[1:].view(t.shape)
        out.copy_(t)
        return out

    args = list(args)
    if what == "h":
        args[0] = shifted(args[0])
    else:
        i = len(args) - 2 if mode == "full_pe" else 1
        args[i] = dataclasses.replace(
            args[i], **{what: shifted(getattr(args[i], what))})
    fm.reset_launches()
    with pytest.raises(ValueError, match="16-byte"):
        getattr(fm, mode)(*args)
    assert sum(fm.launches.values()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("d_out,hidden", [(257, 512), (65, 64)])
def test_f32_ring_refuses_wide_lin_out(cuda_device, d_out, hidden):
    """No fallback past the lin_out limit (256, and no wider than
    hidden): post_combine raises before anything launches."""
    _, (h, w) = _tc_case(cuda_device, ("post_combine", 42, 64, hidden), 1,
                         9, n_post=1, d_out=d_out, dtype=torch.float32)
    fm.reset_launches()
    with pytest.raises(ValueError, match="does not take"):
        fm.post_combine(h, w)
    assert sum(fm.launches.values()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["latent", "w_in", "wz", "w0", "w1", "bz"])
def test_f32_ring_raises_on_unaligned(cuda_device, what):
    """The ring kernel's bulk and TMA copies need 16-byte aligned sources:
    a tensor 4 bytes off raises, and nothing launches (no fallback)."""
    mode, (base, lat, w, code) = _tc_case(cuda_device, "h64", 1, 9,
                                          dtype=torch.float32)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = flat[1:].view(t.shape)
        out.copy_(t)
        return out

    if what == "latent":
        lat = shifted(lat)
    else:
        w = dataclasses.replace(w, **{what: shifted(getattr(w, what))})
    fm.reset_launches()
    with pytest.raises(ValueError, match="16-byte"):
        fm.pre_combine_pe(base, lat, w, code)
    assert sum(fm.launches.values()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_f32_ring_library_refuses_unaligned(cuda_device, mode):
    """The C entry point itself refuses a latent (modes 0, 1) or an h
    (mode 2) 4 bytes off, and a lin_out wider than hidden (modes 0, 2)."""
    _, (base, lat, w, code) = _tc_case(cuda_device, "h64", 1, 9,
                                       dtype=torch.float32)
    lib = fm.load_library()["field_mlp_f32"]
    h = torch.zeros((9, 64), device=cuda_device)
    out = torch.empty((9, 64), device=cuda_device)
    ptrs = [getattr(w, k).data_ptr() for k in fm.WEIGHT_NAMES]
    for off, d_out in ((0, 4), (4, 4), (0, 65)):
        err = lib.field_mlp_f32_launch(
            mode, base.data_ptr(), None,
            h.data_ptr() + (off if mode == 2 else 0),
            lat.data_ptr() + (0 if mode == 2 else off), *ptrs,
            out.data_ptr(), 8, 42, 64, 64, 1, 2, d_out, 6, 1.5, None)
        torch.cuda.synchronize()
        bad = off != 0 or (d_out > 64 and mode != 1)
        assert (err != 0) is bad, (off, d_out, err)


@pytest.mark.cuda
def test_f32_ring_refuses_what_it_does_not_fit(cuda_device):
    """No fallback: an f32 pre_combine whose z-features (80 rounded) are
    wider than hidden (64) raises instead of taking another kernel or the
    twin."""
    mode, (zf, lat, w) = _tc_case(cuda_device, ("pre_combine", 78, 64, 64),
                                  1, 9, dtype=torch.float32)
    fm.reset_launches()
    with pytest.raises(ValueError, match="does not take"):
        fm.pre_combine(zf, lat, w)
    assert sum(fm.launches.values()) == 0


# -- the latent gather (csrc/latent_gather.cu) --------------------------------
#
# The kernel against the plain chain it replaces (ops/grid_sample.py
# ``_corners`` + ``_combine``) run on the card: bitwise, NaN where the chain
# gives NaN, signed zeros included.

GATHER_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
GATHER_PADS = [(p, a) for p in ("zeros", "border", "reflection")
               for a in (True, False)]
# the srn_views view (one table, 64 x 64 x 512 bf16; coarse 16,384 x 64
# points, fine 16,384 x 32: the fine pass reuses the coarse samples'
# latents) and the yolo_detect request (three 64 x 64 x
# 1792 bf16 tables, 256 rays x 128 samples each); both zeros padding,
# aligned corners
GATHER_CELLS = {"srn_views_coarse": (1, 512, 16384 * 64),
                "srn_views_fine": (1, 512, 16384 * 32),
                "yolo_detect": (3, 1792, 256 * 128)}


def _gather_inputs(B, H, W, C, N, dtype, device, seed=0):
    """A (B, H*W, C) table with a few NaN and inf entries, subnormal and
    near-overflow ones, and (B, N, 2) points: in range, out of range, on
    the corners and edges, +-inf and NaN."""
    g = torch.Generator().manual_seed(seed)
    flat = torch.randn((B, H * W, C), generator=g)
    extreme = torch.finfo(dtype).max * 0.75
    tiny = torch.finfo(dtype).smallest_normal * 0.3
    for value in (tiny, -tiny, extreme, -extreme):
        flat.view(-1)[torch.randint(0, flat.numel(), (9,), generator=g)] = \
            value
    flat.view(-1)[torch.randint(0, flat.numel(), (7,), generator=g)] = \
        float("nan")
    flat.view(-1)[torch.randint(0, flat.numel(), (5,), generator=g)] = \
        float("inf")
    flat.view(-1)[torch.randint(0, flat.numel(), (5,), generator=g)] = \
        -float("inf")
    grid = torch.rand((B, N, 2), generator=g) * 2.6 - 1.3
    special = torch.tensor([-1.0, 1.0, 0.0, -1.0 - 1e-7, 1.0 + 1e-7, 7.5,
                            -9.25, float("inf"), -float("inf"),
                            float("nan")])
    k = min(N, 64)
    pick = torch.randint(0, len(special), (B, k, 2), generator=g)
    grid[:, :k] = special[pick]
    return flat.to(dtype).to(device), grid.to(device)


def _gather_plain(flat, grid, H, W, padding, align):
    from pixelnerf_yolo_torch.ops import grid_sample as gs

    return gs._combine(flat, gs._corners(grid, H, W, padding, align),
                       flat.dtype)


def _assert_bitwise(got, ref):
    assert got.dtype == ref.dtype and got.shape == ref.shape
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(got), nan)
    bits = {torch.float32: torch.int32}.get(ref.dtype, torch.int16)
    diff = (got.masked_fill(nan, 0).view(bits)
            != ref.masked_fill(nan, 0).view(bits))
    assert not bool(diff.any()), int(diff.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("B", (1, 3))
@pytest.mark.parametrize("C", (128, 512, 1792, 1536, 200))
@pytest.mark.parametrize("padding,align", GATHER_PADS)
@pytest.mark.parametrize("dtype", GATHER_DTYPES)
def test_latent_gather_matches_chain(cuda_device, dtype, padding, align, C,
                                     B):
    from pixelnerf_yolo_torch.ops import latent_gather as lg

    H, W, N = 12, 17, 1037  # a ragged N and a table that is not square
    flat, grid = _gather_inputs(B, H, W, C, N, dtype, cuda_device, seed=C + B)
    before = lg.launches
    got = lg.latent_gather(flat, grid, H, W, padding, align)
    ref = _gather_plain(flat, grid, H, W, padding, align)
    torch.cuda.synchronize()
    assert lg.launches == before + 1
    _assert_bitwise(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(GATHER_CELLS))
def test_latent_gather_cell_shapes(cuda_device, cell):
    """grid_sample_nhwc at the benchmark cells' lookups takes the kernel
    under no_grad and gives the chain's result."""
    from pixelnerf_yolo_torch.ops import grid_sample as gs
    from pixelnerf_yolo_torch.ops import latent_gather as lg

    B, C, N = GATHER_CELLS[cell]
    flat, grid = _gather_inputs(B, 64, 64, C, N, torch.bfloat16, cuda_device)
    before = lg.launches
    with torch.no_grad():
        got = gs.grid_sample_nhwc(flat, grid, 64, 64, "bilinear", "zeros",
                                  True)
    ref = _gather_plain(flat, grid, 64, 64, "zeros", True)
    torch.cuda.synchronize()
    assert lg.launches == before + 1
    _assert_bitwise(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", GATHER_DTYPES)
def test_latent_gather_narrow_and_unaligned(cuda_device, dtype):
    """Narrower vectors where C or the table's address forbids 16 bytes:
    C of 1, 3, 6 and 12, and a table that starts one element in."""
    from pixelnerf_yolo_torch.ops import latent_gather as lg

    H, W = 5, 7
    for C in (1, 3, 6, 12):
        flat, grid = _gather_inputs(2, H, W, C, 301, dtype, cuda_device,
                                    seed=C)
        got = lg.latent_gather(flat, grid, H, W, "border", False)
        _assert_bitwise(got, _gather_plain(flat, grid, H, W, "border",
                                           False))
    big, grid = _gather_inputs(2, H, W, 65, 301, dtype, cuda_device)
    flat = big.view(-1)[1:1 + 2 * H * W * 64].view(2, H * W, 64)
    got = lg.latent_gather(flat, grid, H, W, "zeros", True)
    _assert_bitwise(got, _gather_plain(flat, grid, H, W, "zeros", True))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_latent_gather_route(cuda_device):
    """A lookup that records a gradient keeps the chain (the kernel does
    not launch) and its gradient; without one the kernel launches."""
    from pixelnerf_yolo_torch.ops import grid_sample as gs
    from pixelnerf_yolo_torch.ops import latent_gather as lg

    flat, grid = _gather_inputs(1, 8, 8, 512, 999, torch.bfloat16,
                                cuda_device)
    flat = torch.nan_to_num(flat.float(), 0.0, 0.0, 0.0).bfloat16()
    table = flat.clone().requires_grad_(True)
    before = lg.launches
    out = gs.grid_sample_nhwc(table, grid, 8, 8, "bilinear", "zeros", True)
    out.float().square().sum().backward()
    assert lg.launches == before
    ref = flat.clone().requires_grad_(True)
    _gather_plain(ref, grid, 8, 8, "zeros", True).float().square().sum() \
        .backward()
    # the same f32 scatter-add, whose atomics may sum in another order
    torch.testing.assert_close(table.grad.float(), ref.grad.float(),
                               rtol=1e-2, atol=1e-6, equal_nan=True)
    with torch.no_grad():
        got = gs.grid_sample_nhwc(table, grid, 8, 8, "bilinear", "zeros",
                                  True)
    assert lg.launches == before + 1
    _assert_bitwise(got, out.detach())


@pytest.mark.cuda
def test_latent_gather_rejects_bad_arguments(cuda_device):
    from pixelnerf_yolo_torch.ops import latent_gather as lg

    flat, grid = _gather_inputs(2, 4, 4, 32, 10, torch.bfloat16, cuda_device)
    bad = [
        (flat.transpose(1, 2).contiguous().transpose(1, 2), grid),  # strides
        (flat, grid.transpose(0, 1).contiguous().transpose(0, 1)),
        (flat, grid.cpu()),  # wrong device
        (flat.double(), grid),  # wrong dtypes
        (flat.to(torch.int8), grid),
        (flat, grid.half()),
        (flat[:1], grid),  # shapes
        (flat[:, :15], grid),
    ]
    for f, g in bad:
        with pytest.raises(ValueError):
            lg.latent_gather(f, g, 4, 4, "zeros", True)
    with pytest.raises(NotImplementedError):
        lg.latent_gather(flat, grid, 4, 4, "wrap", True)
