"""The port's CUDA field-MLP kernels against their plain twins.

This file imports neither jax nor the JAX package, so that it also runs on
a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

The tests marked ``cuda`` need an NVIDIA GPU and skip elsewhere; the rest
check the wrappers' CPU dispatch and argument checks.
"""

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


def _mlp(hidden, d_latent, dtype, seed=0, combine_layer=3):
    g = torch.Generator().manual_seed(seed)
    mlp = ResnetFC(42, d_out=4, n_blocks=5, d_latent=d_latent,
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
                           "post_combine": 1}
    scale = max(1.0, ref.abs().max().item())
    assert (got - ref).abs().max().item() <= TOL[dtype] * scale


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
