"""The bf16 YOLO serving path of the port against the JAX package on the
CPU: the latent gather at the rounding points of the JAX package's one-hot
matmul form (``interp_matmul``) and the latent-table pre-projection
through the lin_z weights (``model.latent_preproject``, JAX's default on
the plain route)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pixelnerf_yolo_tpu.models import make_model as jmake_model
from pixelnerf_yolo_tpu.models.encoder import index_latent as jindex_latent
from pixelnerf_yolo_tpu.ops.grid_sample import grid_sample_nhwc as jgs
from pixelnerf_yolo_tpu.render import make_renderer as jmake_renderer
from pixelnerf_yolo_torch.convert import from_jax_variables
from pixelnerf_yolo_torch.models import make_model
from pixelnerf_yolo_torch.models.encoder import index_latent
from pixelnerf_yolo_torch.ops.grid_sample import grid_sample_nhwc
from pixelnerf_yolo_torch.render import make_renderer
from synth_data import make_yolo_dataset
from torch_parity import (jax_draws, jax_yolo_draws, jax_yolo_trainer,
                          jax_yolo_update, perturbed_variables, port_model,
                          port_yolo_trainer, scene, small_flagship,
                          small_yolo, to_np, yolo_scene)

ULP = 1  # the gather: bf16 units in the last place
# the projected table from the same raw table: one bf16 rounding of a
# product summed in f32 in another order, so 1 ulp, or where the sum
# cancels 2^-11 of max|table| (measured 1.2e-4 on max|table| 0.51)
TABLE_ULP = 1
TABLE_CANCEL = 2.0 ** -11
# forward from the same raw table, JAX's plain route against the port's:
# the same rounding points (measured 0)
FIELD_TOL = 1e-5
# the render: JAX's is jitted, and XLA:CPU adds the deferred lin_z bias
# and the residual in one f32 fusion, rounding once where the op-by-op
# forward (and the port) rounds twice (measured 6.6e-4 on values in
# [-1, 1]; the same from JAX's own projected table)
RENDER_FIELD_TOL = 2e-3
# from each package's own bf16 encoder (tests/test_torch_yolo.py BF16_TOL)
E2E_TOL = 3e-2
LOSS_RTOL = 2e-2  # one bf16 update: each reported loss, relative
GRAD_RTOL = 5e-2  # each gradient tensor, relative L2


def bf16_ulps(a, b):
    """|a - b| in bf16 units in the last place of max(|a|, |b|); equal
    NaNs count 0."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    both_nan = np.isnan(a) & np.isnan(b)
    m = np.maximum(np.abs(a), np.abs(b))
    ulp = 2.0 ** (np.floor(np.log2(np.where(m > 0, m, 1.0))) - 7)
    d = np.where(both_nan, 0.0, np.abs(a - b)) / ulp
    return np.where(m > 0, d, np.where(both_nan | (a == b), 0.0, np.inf))


def _table(hw, c=48, nan_rows=(), seed=0):
    rng = np.random.default_rng(seed)
    flat = rng.normal(size=(2, hw[0] * hw[1], c)).astype(np.float32)
    flat[:, list(nan_rows)] = np.nan
    return flat


def _grid(n=3000, seed=1):
    """Points over [-1.3, 1.3]^2: a quarter outside the table, where the
    border clip makes two or four corners land on one row."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.3, 1.3, size=(2, n, 2)).astype(np.float32)


@pytest.mark.parametrize("hw", [(8, 8), (32, 32)])
@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_one_hot_gather_matches_jax(hw, padding):
    """64- and 1024-row bf16 tables, NaN rows included: the port's four-row
    form at the one-hot rounding points against JAX's matmul form."""
    flat = _table(hw, nan_rows=(0, 5, hw[0] * hw[1] - 1))
    grid = _grid()
    ref = np.asarray(jgs(jnp.asarray(flat).astype(jnp.bfloat16),
                         jnp.asarray(grid), hw[0], hw[1],
                         padding_mode=padding, align_corners=True,
                         interp_matmul=True).astype(jnp.float32))
    got = to_np(grid_sample_nhwc(torch.from_numpy(flat).bfloat16(),
                                 torch.from_numpy(grid), hw[0], hw[1],
                                 padding_mode=padding, align_corners=True,
                                 interp_matmul=True))
    assert np.isfinite(ref).all()  # NaN entries are scrubbed to 0
    assert bf16_ulps(got, ref).max() <= ULP
    # the clip put corners on one row, and they were merged
    assert (np.abs(grid) > 1).any(axis=-1).mean() > 0.2


@pytest.mark.parametrize("hw,nan_scrub_ok", [((25, 41), True),
                                              ((8, 8), False)])
def test_other_tables_take_the_four_corner_form(hw, nan_scrub_ok):
    """A 1025-row table (YOLO path) and the NeRF path (no NaN scrub): the
    four-corner form, NaN rows propagating where NeRF touches them, as in
    JAX's index_latent."""
    flat = _table(hw, nan_rows=(3,))
    grid = _grid()
    tf = torch.from_numpy(flat).bfloat16()
    got = to_np(index_latent(tf, hw, torch.from_numpy(grid), None,
                             index_padding="border",
                             nan_scrub_ok=nan_scrub_ok))
    four = to_np(grid_sample_nhwc(tf, torch.from_numpy(grid), hw[0], hw[1],
                                  padding_mode="border", align_corners=True))
    np.testing.assert_array_equal(got, four)
    ref = np.asarray(jindex_latent(
        jnp.asarray(flat).astype(jnp.bfloat16), hw, jnp.asarray(grid), None,
        index_padding="border", nan_scrub_ok=nan_scrub_ok,
    ).astype(jnp.float32))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(got).any()
    assert bf16_ulps(got, ref).max() <= ULP


# -- pre-projection ---------------------------------------------------------


@pytest.fixture(scope="module")
def yolo_side():
    """The small YOLO flagship in bf16 on the plain route with JAX's
    defaults (pre-projection on), its JAX variables and scene."""
    conf = small_yolo("bfloat16", use_fused_mlp="false")
    conf.put("model.latent_preproject", True)
    jm = jmake_model(conf.get_config("model"))
    images, poses, focal, c, target = yolo_scene(ns=3)
    v = perturbed_variables(jm, images[0], encoder_stats=True)
    return conf, jm, v, (images, poses, focal, c, target)


def _encodes(yolo_side, same_table: bool):
    """(JAX cond, port model, port cond); with same_table the port's
    encoder hands over JAX's raw (unprojected) latent table."""
    conf, jm, v, (images, poses, focal, c, _) = yolo_side
    args = (jnp.asarray(images), jnp.asarray(poses), jnp.asarray(focal))
    jc = jm.encode(v, *args, c=jnp.asarray(c))
    tm = port_model(conf, v)
    if same_table:
        conf_raw = small_yolo("bfloat16", use_fused_mlp="false")
        jraw = jmake_model(conf_raw.get_config("model")).encode(
            v, *args, c=jnp.asarray(c))
        table = torch.from_numpy(np.array(
            jraw.latent_flat.astype(jnp.float32))).reshape(3, 8, 8, -1)
        tm.encoder.forward = lambda x, train=False: table
    with torch.no_grad():
        tc = tm.encode(images, poses, focal, c=c)
    return jc, tm, tc


def test_encode_pre_projects_like_jax(yolo_side):
    jc, tm, tc = _encodes(yolo_side, same_table=True)
    assert jc.latent_projected and tc.latent_projected
    assert tc.latent_flat.dtype == torch.bfloat16
    assert tuple(tc.latent_flat.shape) == (3, 64, 3 * 64)
    ref = np.asarray(jc.latent_flat.astype(jnp.float32))
    got = to_np(tc.latent_flat)
    ok = ((bf16_ulps(got, ref) <= TABLE_ULP)
          | (np.abs(got - ref) <= TABLE_CANCEL * np.abs(ref).max()))
    assert ok.all()


def _points(n=48, seed=0):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-0.3, 0.3, size=(1, n, 3)).astype(np.float32)
    xyz[..., 2] = rng.uniform(1.0, 3.0, size=(1, n))
    return xyz, rng.normal(size=(1, n, 3)).astype(np.float32)


@pytest.mark.parametrize("same_table", [True, False])
def test_forward_pre_projected_matches_jax(yolo_side, same_table):
    _, jm, v, _ = yolo_side
    jc, tm, tc = _encodes(yolo_side, same_table)
    xyz, vd = _points()
    ref = np.asarray(jm.forward(v, jc, jnp.asarray(xyz),
                                viewdirs=jnp.asarray(vd)))
    with torch.no_grad():
        got = to_np(tm.forward(tc, torch.from_numpy(xyz),
                               viewdirs=torch.from_numpy(vd)))
    assert np.isfinite(got).all() and got.shape == ref.shape == (1, 48, 21)
    tol = FIELD_TOL if same_table else E2E_TOL
    np.testing.assert_allclose(got, ref, atol=tol)


@pytest.mark.parametrize("same_table", [True, False])
def test_render_pre_projected_matches_jax(yolo_side, same_table):
    conf, jm, v, (images, poses, focal, c, target) = yolo_side
    jc, tm, tc = _encodes(yolo_side, same_table)
    from pixelnerf_yolo_tpu.utils.camera import gen_rays_yolo

    rays = np.array(gen_rays_yolo(jnp.asarray(target), 8, 8,
                                  jnp.asarray(focal[0] / 8),
                                  jnp.asarray(c[0] / 8), 1.0, 3.0))
    rays = rays.reshape(1, -1, 8)[:, :40]
    jr = jmake_renderer(conf)
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jr(jm, v, jc, jnp.asarray(rays), key))
    u = jax_yolo_draws(key, 40, jr.n_coarse)
    tr = make_renderer(conf, device="cpu")
    got = to_np(tr(tm, tc, torch.from_numpy(rays), u=torch.from_numpy(u)))
    assert got.shape == ref.shape == (1, 40, 3, 7)
    tol = RENDER_FIELD_TOL if same_table else E2E_TOL
    np.testing.assert_allclose(got, ref, atol=tol)


def test_pre_projection_routing():
    """JAX's rule, with "use_fused_mlp not true" read as "the field does
    not take the kernel route": f32, latent_preproject = false, an int8
    table and the kernel route (true or auto: it fits at these widths) do
    not pre-project; mlp_int8 (no kernel route) does."""
    images, poses, focal, c, _ = yolo_scene(ns=3)

    def projected(dtype="bfloat16", fused="false", **puts):
        conf = small_yolo(dtype, use_fused_mlp=fused)
        conf.put("model.latent_preproject", True)
        for k, val in puts.items():
            conf.put(f"model.{k}", val)
        tm = make_model(conf.get_config("model"), device="cpu")
        with torch.no_grad():
            tc = tm.encode(images, poses, focal, c=c)
        assert tm.latent_width(3) == tc.latent_flat.shape[-1]
        return tc.latent_projected

    assert projected()
    assert not projected("float32")
    assert not projected(latent_preproject=False)
    assert not projected(latent_int8=True)
    assert not projected(fused="true")
    assert not projected(fused="auto")
    assert projected(fused="true", mlp_int8=True)


# -- one training update ----------------------------------------------------


@pytest.fixture(scope="module")
def train_data(tmp_path_factory):
    from pixelnerf_yolo_torch.config.hocon import parse_string
    from pixelnerf_yolo_torch.data import DataLoader, YOLODataset
    from torch_parity import yolo_train_conf

    tmp = tmp_path_factory.mktemp("train_preproject")
    root = make_yolo_dataset(str(tmp / "data"), n_scenes=2, n_views=4,
                             img_size=64)
    conf = yolo_train_conf(parse_string, "false")
    val = YOLODataset(root, stage="val", z_near=1, z_far=13.0, conf=conf)
    return root, next(iter(DataLoader(val, batch_size=1)))


def test_bf16_update_pre_projected_matches_jax(tmp_path, train_data):
    """One bf16 update on the plain route with the table pre-projected in
    both packages: the reported losses and every parameter's gradient (the
    lin_z weights' through the projected table)."""
    root, batch = train_data
    puts = {"model.latent_preproject": True}
    jtr, v = jax_yolo_trainer(root, tmp_path, "false", "bfloat16",
                              puts=puts)
    ttr = port_yolo_trainer(root, tmp_path, v, "false", "bfloat16",
                            puts=puts)
    assert jtr.model.preproject and ttr.model._preprojects(3)
    ref_losses, ref_grads, _, u = jax_yolo_update(jtr, batch)
    losses = ttr.train_step(batch, u=torch.from_numpy(u))
    got = np.array([float(losses[k]) for k in
                    ("t", "box_loss", "object_loss", "no_object_loss",
                     "class_loss")])
    np.testing.assert_allclose(got, ref_losses, rtol=LOSS_RTOL)
    ref_g = from_jax_variables({"params": ref_grads,
                                "batch_stats": v["batch_stats"]})
    n_lin_z = 0
    for name, p in ttr.model.named_parameters():
        g, r = p.grad.float().numpy(), ref_g[name].numpy()
        err = np.linalg.norm(g - r) / max(np.linalg.norm(r), 1e-30)
        assert err <= GRAD_RTOL, (name, err)
        n_lin_z += ".lin_z." in name and np.abs(r).max() > 0
    assert n_lin_z == 6  # 3 blocks' weights and biases get a gradient


# -- SPADE ----------------------------------------------------------------------

SPADE_FWD_TOL = 2e-5  # f32 forward
SPADE_RENDER_TOL = 1e-4  # f32 render


@pytest.fixture(scope="module")
def spade_side():
    """The small NeRF flagship (f32, NS=2) with SPADE in both MLPs: per
    block scale_z.N of the latent multiplies the residual stream."""
    conf = small_flagship(use_fused_mlp="auto")
    for m in ("mlp_coarse", "mlp_fine"):
        conf.put(f"model.{m}.use_spade", True)
    jm = jmake_model(conf.get_config("model"))
    images, poses, focal = scene(ns=2)
    v = perturbed_variables(jm, images[0])
    return conf, jm, v, (images, poses, focal)


def test_spade_forward_matches_jax(spade_side):
    conf, jm, v, (images, poses, focal) = spade_side
    tm = port_model(conf, v)
    assert len(tm.mlp_coarse.scale_z) == 3 and not tm._fuses(
        tm.mlp_coarse, 2)
    assert not tm._preprojects(2)
    jc = jm.encode(v, jnp.asarray(images), jnp.asarray(poses),
                   jnp.asarray(focal))
    xyz, vd = _points()
    xyz[..., 2] -= 2.0  # in front of the NeRF cameras
    with torch.no_grad():
        tc = tm.encode(images, poses, focal)
        for coarse in (True, False):
            ref = np.asarray(jm.forward(v, jc, jnp.asarray(xyz),
                                        coarse=coarse,
                                        viewdirs=jnp.asarray(vd)))
            got = to_np(tm.forward(tc, torch.from_numpy(xyz), coarse=coarse,
                                   viewdirs=torch.from_numpy(vd)))
            np.testing.assert_allclose(got, ref, atol=SPADE_FWD_TOL)
    # SPADE changed the field (scale_z is not the identity)
    plain = small_flagship(use_fused_mlp="auto")
    jp = jmake_model(plain.get_config("model"))
    vp = {"params": {**v["params"]}, "batch_stats": v["batch_stats"]}
    for m in ("mlp_coarse", "mlp_fine"):
        vp["params"][m] = {k: p for k, p in v["params"][m].items()
                           if not k.startswith("scale_z")}
    ref0 = np.asarray(jp.forward(vp, jp.encode(
        vp, jnp.asarray(images), jnp.asarray(poses), jnp.asarray(focal)),
        jnp.asarray(xyz), viewdirs=jnp.asarray(vd)))
    assert np.abs(got - ref0).max() > 1e-2


def test_spade_render_matches_jax(spade_side):
    from pixelnerf_yolo_torch.ops import field_mlp
    from pixelnerf_yolo_tpu.utils.camera import gen_rays

    conf, jm, v, (images, poses, focal) = spade_side
    rays = np.array(gen_rays(jnp.asarray(poses[0]), 8, 8,
                             jnp.asarray(focal), 0.8, 1.8)).reshape(
        1, -1, 8)[:, :40]
    jr = jmake_renderer(conf)
    key = jax.random.PRNGKey(4)
    jc = jm.encode(v, jnp.asarray(images), jnp.asarray(poses),
                   jnp.asarray(focal))
    ref = jr(jm, v, jc, jnp.asarray(rays), key)
    tm = port_model(conf, v)
    field_mlp.reset_launches()
    with torch.no_grad():
        tc = tm.encode(images, poses, focal)
        out = make_renderer(conf, device="cpu")(
            tm, tc, torch.from_numpy(rays), draws=jax_draws(jr, key, 40))
    assert sum(field_mlp.launches.values()) == 0
    for p in ("coarse", "fine"):
        for k in ("rgb", "depth"):
            np.testing.assert_allclose(to_np(out[p][k]),
                                       np.asarray(ref[p][k]),
                                       atol=SPADE_RENDER_TOL)
