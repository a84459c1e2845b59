"""The port's int8 serving modes against the JAX package on the CPU: the
quantizers and the dynamic W8A8 product (nn/quant.py), the int8 latent
table (``model.latent_int8``: ``quantize_rows_int8``,
``grid_sample_nhwc_q8``) and the int8 field MLP (``model.mlp_int8``), with
the same weights (``convert``) and inputs."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pixelnerf_yolo_tpu.models import make_model as jmake_model
from pixelnerf_yolo_tpu.models.encoder import index_latent as jindex_latent
from pixelnerf_yolo_tpu.nn import quant as jquant
from pixelnerf_yolo_tpu.nn.resnetfc import ResnetFC as JResnetFC
from pixelnerf_yolo_tpu.ops import grid_sample as jgs
from pixelnerf_yolo_torch.convert import resnetfc_state_dict
from pixelnerf_yolo_torch.models import make_model
from pixelnerf_yolo_torch.models.encoder import index_latent
from pixelnerf_yolo_torch.nn import quant
from pixelnerf_yolo_torch.nn.resnetfc import ResnetFC
from pixelnerf_yolo_torch.ops import grid_sample as tgs
from test_torch_serving import bf16_ulps
from torch_parity import (perturbed_variables, port_model, scene,
                          small_flagship, small_yolo, to_np, yolo_scene)

# Tolerances relative to max(1, max|ref|).  ResnetFC(int8) against flax:
# the same integer products, but an activation that one package rounds to
# the other side of a .5 moves one int8 level (measured 1.2e-7 at 1,000
# rows; 4.8e-4 in f32 and 6.9e-4 in bf16 at 2^17 rows, where a few flip)
INT8_MLP_TOL = 2e-3
# model forwards with latent_int8 or mlp_int8: f32 measured at most 2.9e-5
# (latent_int8, NeRF: a table entry quantized across a .5); bf16 at most
# 3.3e-3, from the two packages' own bf16 encoders (tests/test_torch_yolo.py)
MODEL_F32_TOL = 1e-4
MODEL_BF16_TOL = 2e-2
Q8_JIT_ULP = 2
# JAX's own bounds for the int8 modes against exact
# (tests/test_model_render.py TestLatentInt8; tests/test_quant.py)
LATENT_INT8_RENDER_TOL = 0.05
MLP_INT8_RGB_TOL = 0.12


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantizers_and_product_match_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(37, 96)).astype(np.float32) * 3
    x[4] = 0.0  # an all-zero row takes the eps scale
    w = rng.normal(size=(96, 40)).astype(np.float32)
    flat = rng.normal(size=(2, 50, 24)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))
    for jfn, tfn, a, b in ((jquant.quantize_rows, quant.quantize_rows, jx,
                            tx),
                           (jquant.quantize_cols, quant.quantize_cols,
                            jnp.asarray(w), torch.from_numpy(w))):
        (jq, js), (tq, ts) = jfn(a), tfn(b)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jq, js = jgs.quantize_rows_int8(jnp.asarray(flat))
    tq, ts = tgs.quantize_rows_int8(torch.from_numpy(flat))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        quant.dot_w8a8(tx, torch.from_numpy(w)).numpy(),
        np.asarray(jquant.dot_w8a8(jx, jnp.asarray(w))))


def test_int_mm_is_exact():
    rng = np.random.default_rng(1)
    a = rng.integers(-127, 128, size=(19, 42)).astype(np.int8)
    b = rng.integers(-127, 128, size=(42, 21)).astype(np.int8)
    got = quant.int_mm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64))


@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_grid_sample_q8_matches_jax(padding):
    """Exact against JAX's function run op by op; against it under jit
    within Q8_JIT_ULP: where XLA:CPU fuses the corner sum into one f32 sum
    (one rounding), a sum that cancels moves 2 ulps (2 of 32,000 entries
    here, zeros padding; the port rounds each add, as the op-by-op form)."""
    rng = np.random.default_rng(2)
    flat = rng.normal(size=(2, 6 * 7, 32)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, size=(2, 500, 2)).astype(np.float32)
    jq, js = jgs.quantize_rows_int8(jnp.asarray(flat))

    def ref():
        return np.asarray(jgs.grid_sample_nhwc_q8(
            jq, js, jnp.asarray(grid), 6, 7, padding_mode=padding,
            align_corners=True).astype(jnp.float32))

    tq, ts = tgs.quantize_rows_int8(torch.from_numpy(flat))
    got = tgs.grid_sample_nhwc_q8(tq, ts, torch.from_numpy(grid), 6, 7,
                                  padding_mode=padding, align_corners=True)
    assert got.dtype == torch.bfloat16
    with jax.disable_jit():
        np.testing.assert_array_equal(to_np(got), ref())
    assert bf16_ulps(to_np(got), ref()).max() <= Q8_JIT_ULP


def test_index_latent_int8_refuses_nearest():
    rng = np.random.default_rng(3)
    q = torch.zeros((1, 4, 8), dtype=torch.int8)
    uv = torch.from_numpy(rng.uniform(-1, 1, (1, 5, 2)).astype(np.float32))
    with pytest.raises(NotImplementedError) as got:
        index_latent(q, (2, 2), uv, None, index_interp="nearest",
                     scales=torch.ones(8))
    with pytest.raises(NotImplementedError) as ref:
        jindex_latent(jnp.zeros((1, 4, 8), jnp.int8), (2, 2),
                      jnp.asarray(uv.numpy()), None, index_interp="nearest",
                      scales=jnp.ones(8))
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [1000, 1 << 17])
def test_resnetfc_int8_matches_flax(dtype, rows):
    """ResnetFC(int8): per-block lin_z at 1,000 rows, JAX's merged lin_z
    product (compute-dtype weights and biases) at 2^17."""
    kw = dict(d_out=5, n_blocks=4, d_latent=24, d_hidden=32, combine_layer=2)
    jmlp = JResnetFC(dtype=dtype, **kw)
    rng = np.random.default_rng(4)
    zx = rng.normal(size=(rows, 24 + 9)).astype(np.float32)
    v = jmlp.init(jax.random.PRNGKey(0), jnp.asarray(zx[:4]))
    v = jax.tree.map(lambda t: t + 0.05 * jax.random.normal(
        jax.random.PRNGKey(t.size), t.shape), v)
    ref = np.asarray(jmlp.apply(v, jnp.asarray(zx), int8=True))
    tmlp = ResnetFC(9, dtype=getattr(torch, dtype), **kw)
    tmlp.load_state_dict(resnetfc_state_dict(
        jax.tree.map(np.asarray, v["params"])))
    with torch.no_grad():
        got = tmlp(torch.from_numpy(zx), int8=True).numpy()
        plain = tmlp(torch.from_numpy(zx)).numpy()
    np.testing.assert_allclose(got, ref, atol=INT8_MLP_TOL * max(
        1.0, np.abs(ref).max()))
    assert np.abs(got - plain).max() > 0  # the int8 product engaged


# -- the model ----------------------------------------------------------------


def _nerf(dtype, **puts):
    conf = small_flagship(compute_dtype=dtype, use_fused_mlp="false")
    for k, val in puts.items():
        conf.put(f"model.{k}", val)
    return conf


def _yolo(dtype, **puts):
    conf = small_yolo(dtype, use_fused_mlp="false")
    for k, val in puts.items():
        conf.put(f"model.{k}", val)
    return conf


@pytest.fixture(scope="module")
def variables():
    """Perturbed JAX variables of the small NeRF and YOLO flagships."""
    out = {}
    for mode, make, images in (("nerf", _nerf, scene()[0]),
                               ("yolo", _yolo, yolo_scene(ns=3)[0])):
        jm = jmake_model(make("float32").get_config("model"))
        out[mode] = perturbed_variables(jm, images[0])
    return out


def _inputs(mode):
    rng = np.random.default_rng(5)
    n = 64
    if mode == "nerf":
        images, poses, focal = scene(ns=2)
        enc = (images, poses, focal), {}
        xyz = rng.uniform(-0.3, 0.3, size=(1, n, 3)).astype(np.float32)
    else:
        images, poses, focal, c, _ = yolo_scene(ns=3)
        enc = (images, poses, focal), {"c": c}
        xyz = rng.uniform(-0.3, 0.3, size=(1, n, 3)).astype(np.float32)
        xyz[..., 2] = rng.uniform(1.0, 3.0, size=(1, n))
    return enc, xyz, rng.normal(size=(1, n, 3)).astype(np.float32)


def _forward_pair(conf, v, mode):
    jm = jmake_model(conf.get_config("model"))
    tm = port_model(conf, v)
    (args, kw), xyz, vd = _inputs(mode)
    jc = jm.encode(v, *map(jnp.asarray, args),
                   **{k: jnp.asarray(x) for k, x in kw.items()})
    with torch.no_grad():
        tc = tm.encode(*args, **kw)
        got = to_np(tm.forward(tc, torch.from_numpy(xyz),
                               viewdirs=torch.from_numpy(vd)))
    ref = np.asarray(jm.forward(v, jc, jnp.asarray(xyz),
                                viewdirs=jnp.asarray(vd)), np.float32)
    return got, ref, tc, jc


@pytest.mark.parametrize("mode", ["nerf", "yolo"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_latent_int8_matches_jax(variables, mode, dtype):
    make = _nerf if mode == "nerf" else _yolo
    got, ref, tc, jc = _forward_pair(make(dtype, latent_int8=True),
                                     variables[mode], mode)
    assert tc.latent_flat.dtype == torch.int8
    assert tc.latent_scales is not None and not tc.latent_projected
    assert np.isfinite(got).all()
    _close(got, ref, dtype)
    exact, _, _, _ = _forward_pair(make(dtype), variables[mode], mode)
    assert np.abs(got - exact).max() > 0


def _close(got, ref, dtype):
    tol = MODEL_F32_TOL if dtype == "float32" else MODEL_BF16_TOL
    np.testing.assert_allclose(got, ref, atol=tol * max(1.0,
                                                        np.abs(ref).max()))


@pytest.mark.parametrize("mode", ["nerf", "yolo"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_mlp_int8_matches_jax(variables, mode, dtype):
    make = _nerf if mode == "nerf" else _yolo
    got, ref, tc, _ = _forward_pair(make(dtype, mlp_int8=True),
                                    variables[mode], mode)
    assert tc.mlp_int8
    _close(got, ref, dtype)
    exact, _, _, _ = _forward_pair(make(dtype), variables[mode], mode)
    if mode == "nerf":  # JAX's bound on rgb (tests/test_quant.py)
        assert np.abs(got[..., :3] - exact[..., :3]).max() < MLP_INT8_RGB_TOL
    assert np.abs(got - exact).max() > 0


def test_latent_int8_render_close_to_exact(variables):
    """JAX's own check (tests/test_model_render.py TestLatentInt8): the
    coarse rgb of a render with the int8 table within 0.05 of exact."""
    from pixelnerf_yolo_torch.render import make_renderer
    from pixelnerf_yolo_torch.utils.camera import gen_rays

    outs = []
    images, poses, focal = scene(ns=2)
    rays = gen_rays(torch.from_numpy(poses[0, :1]), 4, 4,
                    torch.tensor(focal), 0.8, 1.8).reshape(1, -1, 8)
    for puts in ({"latent_int8": True}, {}):
        conf = _nerf("float32", **puts)
        tm = port_model(conf, variables["nerf"])
        with torch.no_grad():
            tc = tm.encode(images, poses, focal)
        r = make_renderer(conf, device="cpu")
        outs.append(r(tm, tc, rays, generator=torch.Generator()
                      .manual_seed(5))["coarse"]["rgb"])
    assert (outs[0] - outs[1]).abs().max() <= LATENT_INT8_RENDER_TOL


def test_train_encode_disables_int8(variables):
    conf = _nerf("float32", latent_int8=True, mlp_int8=True)
    tm = port_model(conf, variables["nerf"])
    (args, _), _, _ = _inputs("nerf")
    with torch.no_grad():
        ev = tm.encode(*args)
        tr = tm.encode(*args, train=True)
    assert ev.latent_flat.dtype == torch.int8 and ev.mlp_int8
    assert tr.latent_flat.dtype == torch.float32 and not tr.mlp_int8
    assert tr.latent_scales is None
    assert not tm._fuses(tm.mlp_coarse, 2)  # the kernels have no int8 path


def test_mlp_int8_refuses_other_mlps():
    from pixelnerf_yolo_tpu.config.hocon import parse_string as jparse

    conf = _nerf("float32", mlp_int8=True)
    conf.put("model.mlp_coarse.type", "mlp")
    with pytest.raises(ValueError) as got:
        make_model(conf.get_config("model"), device="cpu")
    jconf = jparse("{}")
    jconf.put("model", conf.get_config("model").to_dict())
    with pytest.raises(ValueError) as ref:
        jmake_model(jconf.get_config("model"))
    assert str(got.value) == str(ref.value)
