"""The port's field MLP against the JAX package: the plain ResnetFC against
flax ``apply``, and each fused kernel's plain twin against the Pallas
kernel it replaces (interpret mode on the CPU, as tests/test_pallas.py runs
it).  The CUDA kernels themselves are held against their twins in
tests/test_torch_kernels.py."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pixelnerf_yolo_tpu.nn.resnetfc import ResnetFC as JResnetFC
from pixelnerf_yolo_tpu.ops.pallas import fused_mlp as jfm
from pixelnerf_yolo_torch.convert import resnetfc_state_dict
from pixelnerf_yolo_torch.nn.code import PositionalEncoding
from pixelnerf_yolo_torch.nn.resnetfc import ResnetFC
from pixelnerf_yolo_torch.ops import field_mlp

D_LAT, D_IN, H, NB, CL = 64, 42, 64, 5, 3
FREQS = tuple(1.5 * 2.0**i for i in range(6))
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# f32: accumulation order only (measured max 2.9e-6 on outputs up to 17).
# bf16: the same rounding points on both sides, but another f32 summation
# order can flip one bf16 rounding (measured max 3.1e-2, one bf16 ulp, on
# outputs up to 15); the bound is one ulp at 16.
TOL = {"float32": 2e-5, "bfloat16": 6e-2}


def _mlps(dtype, seed=0, beta=0.0, cl=CL):
    jd, td = DTYPES[dtype]
    jmlp = JResnetFC(d_out=4, n_blocks=NB, d_latent=D_LAT, d_hidden=H,
                     combine_layer=cl, combine_type="average", dtype=dtype,
                     beta=beta)
    params = jmlp.init(jax.random.PRNGKey(seed),
                       jnp.zeros((2, D_LAT + D_IN)))["params"]
    # fc_1 is zero-init; give every weight signal
    params = jax.tree.map(
        lambda x: np.asarray(
            x + 0.05 * jax.random.normal(jax.random.PRNGKey(9), x.shape)),
        params)
    tmlp = ResnetFC(D_IN, d_out=4, n_blocks=NB, d_latent=D_LAT, d_hidden=H,
                    combine_layer=cl, dtype=td, beta=beta)
    tmlp.load_state_dict(resnetfc_state_dict(params), strict=True)
    return jmlp, params, tmlp


def _inputs(rng, rows):
    latent = rng.normal(size=(rows, D_LAT)).astype(np.float32)
    base = rng.normal(size=(rows, 6)).astype(np.float32)
    base[:, :3] *= 0.5
    return latent, base


@pytest.mark.parametrize("dtype,beta", [("float32", 0.0), ("bfloat16", 0.0),
                                        ("float32", 2.0)])
@pytest.mark.parametrize("ns", [1, 3])
def test_resnetfc_matches_flax(rng, dtype, beta, ns):
    """beta > 0 swaps relu for softplus(beta x) / beta."""
    jmlp, params, tmlp = _mlps(dtype, beta=beta)
    B = 12
    zx = rng.normal(size=(2 * ns * B, D_LAT + D_IN)).astype(np.float32)
    ref = np.asarray(jmlp.apply({"params": params}, jnp.asarray(zx),
                                combine_inner_dims=(ns, B)))
    with torch.no_grad():
        got = tmlp(torch.from_numpy(zx), combine_inner_dims=(ns, B)).numpy()
    assert got.shape == ref.shape == (2, B, 4)
    np.testing.assert_allclose(got, ref, atol=TOL[dtype])


def _stacked(params, tmlp, dtype):
    jd, td = DTYPES[dtype]
    return (jfm._stack_params(params, NB, CL, jd),
            field_mlp.stack_params(tmlp, td))


def _pe():
    m, p, mask = jfm.make_pe_matrix(FREQS)
    return jnp.asarray(m), jnp.asarray(p), jnp.asarray(mask)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_pe_twin_matches_pallas(rng, dtype):
    jd, td = DTYPES[dtype]
    _, params, tmlp = _mlps(dtype)
    js, ts = _stacked(params, tmlp, dtype)
    latent, base = _inputs(rng, 200)  # ragged against the 128-row tile
    ref = np.asarray(jfm.fused_full_pe(
        jnp.asarray(base), jnp.asarray(latent, jd), *_pe(), *js, tile=128))
    got = field_mlp.full_pe(
        torch.from_numpy(base), torch.from_numpy(latent).to(td), ts,
        PositionalEncoding(6, 3, 1.5, True)).numpy()
    assert got.dtype == np.float32 and got.shape == (200, 4)
    np.testing.assert_allclose(got, ref, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pre_combine_pe_twin_matches_pallas(rng, dtype):
    jd, td = DTYPES[dtype]
    _, params, tmlp = _mlps(dtype)
    js, ts = _stacked(params, tmlp, dtype)
    latent, base = _inputs(rng, 200)
    ref = np.asarray(jfm.fused_pre_combine_pe(
        jnp.asarray(base), jnp.asarray(latent, jd), *_pe(), *js[:8],
        tile=128).astype(jnp.float32))
    got = field_mlp.pre_combine_pe(
        torch.from_numpy(base), torch.from_numpy(latent).to(td), ts,
        PositionalEncoding(6, 3, 1.5, True))
    assert got.dtype == td and got.shape == (200, H)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_post_combine_twin_matches_pallas(rng, dtype):
    jd, td = DTYPES[dtype]
    _, params, tmlp = _mlps(dtype)
    js, ts = _stacked(params, tmlp, dtype)
    h = rng.normal(size=(200, H)).astype(np.float32)
    ref = np.asarray(jfm.fused_post_combine(jnp.asarray(h, jd), *js[8:],
                                            tile=128))
    got = field_mlp.post_combine(torch.from_numpy(h).to(td), ts).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ns", [1, 2])
def test_fused_pe_forward_matches_jax(rng, dtype, ns):
    """The dispatch (one kernel at NS=1, pre + f32 view mean + post at
    NS>1) against the JAX package's ``_fused_pe_forward``."""
    jd, td = DTYPES[dtype]
    _, params, tmlp = _mlps(dtype)
    B = 40
    latent, base = _inputs(rng, 2 * ns * B)
    ref = np.asarray(jfm._fused_pe_forward(
        params, jnp.asarray(latent), jnp.asarray(base), NB, CL, ns, B, jd,
        FREQS))
    got = field_mlp.fused_pe_forward(
        tmlp, torch.from_numpy(latent), torch.from_numpy(base), ns, B, td,
        PositionalEncoding(6, 3, 1.5, True)).numpy()
    assert got.shape == (2 * B, 4)
    np.testing.assert_allclose(got, ref, atol=TOL[dtype])


def test_fused_pe_forward_without_post_blocks(rng):
    """NS=1 with combine_layer == n_blocks: pre_combine_pe, then
    post_combine with no block (lin_out alone).  The JAX package's
    ``_can_fuse`` admits this case but its ``_stack_params`` cannot stack
    zero post blocks, so the reference here is flax ``apply``."""
    jmlp, params, tmlp = _mlps("float32", cl=NB)
    B = 40
    latent, base = _inputs(rng, 2 * B)
    code = PositionalEncoding(6, 3, 1.5, True)
    w = field_mlp.stack_params(tmlp, torch.float32)
    assert w.w0p.shape == (0, H, H) and w.b1p.shape == (0, H)
    zx = np.concatenate([latent, field_mlp.pe_features(
        torch.from_numpy(base), code).numpy()], axis=-1)
    ref = np.asarray(jmlp.apply({"params": params}, jnp.asarray(zx),
                                combine_inner_dims=(1, 2 * B)))
    got = field_mlp.fused_pe_forward(
        tmlp, torch.from_numpy(latent), torch.from_numpy(base), 1, 2 * B,
        torch.float32, code).numpy()
    np.testing.assert_allclose(got, ref.reshape(-1, 4), atol=TOL["float32"])


def test_can_fuse_follows_jax():
    """Eligibility: NS=1 takes any combine_layer, NS>1 needs a
    post-combine block (the JAX package's condition)."""
    from types import SimpleNamespace

    from pixelnerf_yolo_torch.models.pixelnerf import PixelNeRF

    stub = SimpleNamespace(use_fused_mlp="auto", d_in=D_IN,
                           compute_dtype=torch.float32)
    for cl, ns, want in [(CL, 1, True), (CL, 2, True), (NB, 1, True),
                         (NB, 2, False)]:
        _, _, tmlp = _mlps("float32", cl=cl)
        assert PixelNeRF._can_fuse(stub, tmlp, ns) is want, (cl, ns)
    stub.use_fused_mlp = "false"
    assert PixelNeRF._can_fuse(stub, tmlp, 1) is False


def test_stacked_params_cached_until_weights_change():
    _, _, tmlp = _mlps("float32")
    w = field_mlp.stacked_params(tmlp, torch.float32)
    assert field_mlp.stacked_params(tmlp, torch.float32) is w
    with torch.no_grad():
        tmlp.lin_out.weight.mul_(2.0)
    w2 = field_mlp.stacked_params(tmlp, torch.float32)
    assert w2 is not w
    torch.testing.assert_close(w2.w_out, 2.0 * w.w_out, rtol=0, atol=0)
    assert field_mlp.stacked_params(tmlp, torch.bfloat16).w_in.dtype \
        == torch.bfloat16


def test_fits_and_smem_budget():
    # the flagship widths fit in both dtypes; f32 at 512/512 is the
    # largest latent tile the 227 KB budget takes
    for dt in (torch.float32, torch.bfloat16):
        assert field_mlp.fits(42, 512, 512, dt)
    assert field_mlp.smem_bytes("full_pe", 4, 512, 512) <= field_mlp.SMEM_LIMIT
    assert not field_mlp.fits(42, 1792, 512, torch.float32)
    assert not field_mlp.fits(42, 512, 96, torch.float32)
    assert not field_mlp.fits(42, 512, 1024, torch.bfloat16)
    assert not field_mlp.fits(42, 512, 512, torch.float16)
    assert field_mlp.fits(0, 0, 512, torch.float32, mode="post_combine")


def test_wrappers_refuse_other_devices():
    """Off the CPU and off CUDA a wrapper neither falls back nor launches."""
    _, _, tmlp = _mlps("float32")
    ts = field_mlp.stack_params(tmlp.to("meta"), torch.float32)
    h = torch.empty((8, H), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        field_mlp.post_combine(h, ts)
    assert field_mlp.launches["post_combine"] == 0
