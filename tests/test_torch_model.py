"""The port's encoder, weight conversion, model and renderer against the
JAX package, on the flagship conf at test size (resnet18, 2 layers,
d_hidden 64, 32x32 source images), with the same weights and draws."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pixelnerf_yolo_tpu.models import make_model as jmake_model
from pixelnerf_yolo_tpu.ops.ray_sampling import sample_fine as jsample_fine
from pixelnerf_yolo_tpu.render import make_renderer as jmake_renderer
from pixelnerf_yolo_tpu.train.convert import convert_reference_state_dict
from pixelnerf_yolo_tpu.utils.camera import gen_rays
from pixelnerf_yolo_torch.convert import from_jax_variables
from pixelnerf_yolo_torch.ops import field_mlp
from pixelnerf_yolo_torch.ops.ray_sampling import sample_fine
from pixelnerf_yolo_torch.render import NeRFRenderer, make_renderer
from torch_parity import (jax_draws, perturbed_variables, port_model,
                          scene, small_flagship, to_np)

N_RAYS = 40
FWD_TOL = 2e-5  # module-level f32 forwards
RENDER_TOL = 1e-4  # whole render, f32


@pytest.fixture(scope="module")
def jax_side():
    conf = small_flagship()
    jm = jmake_model(conf.get_config("model"))
    images, _, _ = scene(ns=2)
    return conf, jm, perturbed_variables(jm, images[0])


def _rays(poses, focal):
    rays = gen_rays(jnp.asarray(poses[0]), 8, 8, jnp.asarray(focal), 0.8, 1.8)
    return np.array(rays).reshape(1, -1, 8)[:, :N_RAYS]


def test_encoder_matches(jax_side):
    conf, jm, v = jax_side
    images, _, _ = scene(ns=2)
    x = np.transpose(images[0], (0, 2, 3, 1))
    ref = np.asarray(jm.encoder.apply(
        {"params": v["params"]["encoder"],
         "batch_stats": v["batch_stats"]["encoder"]}, jnp.asarray(x)))
    tm = port_model(conf, v)
    with torch.no_grad():
        got = tm.encoder(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 16, 16, 128)
    np.testing.assert_allclose(got, ref, atol=FWD_TOL)


def test_weights_round_trip(jax_side):
    """JAX variables -> port state_dict -> the JAX package's own reference
    converter gives the original variables back."""
    conf, _, v = jax_side
    sd = port_model(conf, v).state_dict()
    back = convert_reference_state_dict(
        {k: t.numpy() for k, t in sd.items()}, backbone="resnet18")
    flat_v = dict(jax.tree_util.tree_leaves_with_path(v))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert flat_v.keys() == flat_b.keys()
    for k, a in flat_v.items():
        np.testing.assert_array_equal(np.asarray(flat_b[k]), a, err_msg=str(k))
    assert sd["mlp_coarse.blocks.4.fc_1.weight"].shape == (64, 64)
    assert sd["encoder.model.layer1.1.bn2.running_var"].shape == (64,)


@pytest.mark.parametrize("fused", ["true", "false"])
@pytest.mark.parametrize("ns", [1, 2])
def test_encode_and_forward_match(jax_side, rng, fused, ns):
    conf, _, v = jax_side
    conf = small_flagship(use_fused_mlp=fused)
    jm = jmake_model(conf.get_config("model"))
    tm = port_model(conf, v)
    images, poses, focal = scene(ns=ns)
    jc = jm.encode(v, jnp.asarray(images), jnp.asarray(poses),
                   jnp.asarray(focal))
    tc = tm.encode(images, poses, focal)
    np.testing.assert_allclose(to_np(tc.latent_flat), np.asarray(jc.latent_flat),
                               atol=FWD_TOL)
    np.testing.assert_allclose(to_np(tc.poses), np.asarray(jc.poses), atol=1e-6)
    np.testing.assert_array_equal(to_np(tc.focal), np.asarray(jc.focal))
    xyz = (rng.normal(size=(1, 50, 3)) * 0.3).astype(np.float32)
    vd = rng.normal(size=(1, 50, 3)).astype(np.float32)
    field_mlp.reset_launches()
    for coarse in (True, False):
        ref = np.asarray(jm.forward(v, jc, jnp.asarray(xyz), coarse=coarse,
                                    viewdirs=jnp.asarray(vd)))
        got = to_np(tm.forward(tc, torch.from_numpy(xyz), coarse=coarse,
                               viewdirs=torch.from_numpy(vd)))
        assert got.shape == ref.shape == (1, 50, 4)
        np.testing.assert_allclose(got, ref, atol=FWD_TOL)
    # on CPU tensors the fused route runs the twins, never a kernel
    assert sum(field_mlp.launches.values()) == 0


def test_superbatch_forward_matches(jax_side, rng):
    """Two scenes of two views each, per-scene focal and principal point:
    rows are ordered (scene, view, point) on both sides."""
    conf, jm, v = jax_side
    tm = port_model(conf, v)
    images = np.concatenate([scene(ns=2, seed=s)[0] for s in (0, 1)])
    poses = np.concatenate([scene(ns=2)[1]] * 2)
    poses[1, :, 1, 3] = 0.05
    focal = np.asarray([[28.0, 29.0], [30.0, 31.0]], np.float32)
    c = np.asarray([[16.0, 15.5], [16.5, 16.0]], np.float32)
    jc = jm.encode(v, jnp.asarray(images), jnp.asarray(poses),
                   jnp.asarray(focal), c=jnp.asarray(c))
    tc = tm.encode(images, poses, focal, c=c)
    xyz = (rng.normal(size=(2, 30, 3)) * 0.3).astype(np.float32)
    vd = rng.normal(size=(2, 30, 3)).astype(np.float32)
    ref = np.asarray(jm.forward(v, jc, jnp.asarray(xyz),
                                viewdirs=jnp.asarray(vd)))
    got = to_np(tm.forward(tc, torch.from_numpy(xyz),
                           viewdirs=torch.from_numpy(vd)))
    assert got.shape == ref.shape == (2, 30, 4)
    np.testing.assert_allclose(got, ref, atol=FWD_TOL)


@pytest.fixture(scope="module")
def render_ref(jax_side):
    """The JAX render of the flagship entry's NS=2 scene, and its draws."""
    conf, jm, v = jax_side
    images, poses, focal = scene(ns=2)
    jc = jm.encode(v, jnp.asarray(images), jnp.asarray(poses),
                   jnp.asarray(focal))
    rays = _rays(poses, focal)
    jr = jmake_renderer(conf)
    key = jax.random.PRNGKey(1)
    out = jax.tree.map(np.asarray, jr(jm, v, jc, jnp.asarray(rays), key,
                                      want_weights=True))
    return rays, jax_draws(jr, key, N_RAYS), out


def _port_render(conf, v, rays, draws, want_weights, renderer=None):
    tm = port_model(conf, v)
    images, poses, focal = scene(ns=2)
    tc = tm.encode(images, poses, focal)
    tr = renderer or make_renderer(conf, device="cpu")
    out = tr(tm, tc, rays, draws=draws, want_weights=want_weights)
    return jax.tree.map(to_np, out)


@pytest.mark.parametrize("fused", ["auto", "false"])
@pytest.mark.parametrize("want_weights", [True, False])
def test_render_matches_jax(jax_side, render_ref, fused, want_weights):
    _, _, v = jax_side
    rays, draws, ref = render_ref
    conf = small_flagship(use_fused_mlp=fused)
    got = _port_render(conf, v, rays, draws, want_weights)
    # the fine samples first: inverse-CDF sampling is discontinuous in
    # the coarse weights, so a bin flip would show here before rgb/depth
    r = conf.get_config("renderer")
    n_imp, nc = r.get_int("n_fine") - r.get_int("n_fine_depth"), r.get_int(
        "n_coarse")
    if want_weights:
        z_ref = np.asarray(jsample_fine(rays[0], ref["coarse"]["weights"][0],
                                        n_imp, nc, u=draws["u"],
                                        u_jitter=draws["u_jitter"]))
        z_got = sample_fine(torch.from_numpy(rays[0]),
                            torch.from_numpy(got["coarse"]["weights"][0]),
                            n_imp, nc, u=torch.from_numpy(draws["u"]),
                            u_jitter=torch.from_numpy(draws["u_jitter"]))
        np.testing.assert_allclose(z_got.numpy(), z_ref, atol=1e-5)
    for p in ("coarse", "fine"):
        keys = ("rgb", "depth") + (("weights",) if want_weights else ())
        assert set(got[p]) == set(keys)
        for k in keys:
            assert got[p][k].shape == ref[p][k].shape
            np.testing.assert_allclose(got[p][k], ref[p][k], atol=RENDER_TOL,
                                       err_msg=f"{p}.{k}")
    # the outputs are not degenerate: some weight mass, not all of it
    wsum = ref["fine"]["weights"].sum(-1)
    assert 0.05 < wsum.mean() < 0.99


@pytest.mark.parametrize("chunk", [8, 16])
def test_chunk_size_invariance(jax_side, render_ref, chunk):
    """The draws are made over the whole (padded) batch, so the result does
    not depend on the ray chunk; 16 pads 40 rays to 48."""
    conf, _, v = jax_side
    rays, draws, _ = render_ref

    class Chunked(NeRFRenderer):
        def _chunk_rays(self, *a, **k):
            return chunk

    base = make_renderer(conf, device="cpu")
    small = Chunked(**{f: getattr(base, f)
                       for f in base.__dataclass_fields__})
    pad = (-N_RAYS) % chunk
    padded = {k: np.concatenate([d, d[:pad]]) for k, d in draws.items()}
    full = _port_render(conf, v, rays, draws, True)
    got = _port_render(conf, v, rays, padded, True, renderer=small)
    for p in ("coarse", "fine"):
        for k in ("rgb", "depth", "weights"):
            np.testing.assert_allclose(got[p][k], full[p][k], atol=1e-5)


def test_render_draws_from_generator(jax_side):
    conf, _, v = jax_side
    tm = port_model(conf, v)
    images, poses, focal = scene(ns=2)
    tc = tm.encode(images, poses, focal)
    tr = make_renderer(conf, device="cpu")
    rays = _rays(poses, focal)
    a, b = (tr(tm, tc, rays, generator=torch.Generator().manual_seed(5))
            for _ in range(2))
    assert torch.equal(a["fine"]["rgb"], b["fine"]["rgb"])
    assert a["fine"]["rgb"].shape == (1, N_RAYS, 3)
    assert bool(torch.isfinite(a["fine"]["depth"]).all())


def test_sched_step_matches_jax():
    conf = small_flagship()
    conf.put("renderer.sched", [[2, 5], [32, 16], [16, 8]])
    jr, tr = jmake_renderer(conf), make_renderer(conf, device="cpu")
    js, ts = {}, {}
    for steps in (1, 1, 2, 3):
        jr, js = jr.sched_step(js, steps)
        tr, ts = tr.sched_step(ts, steps)
        assert (tr.n_coarse, tr.n_fine) == (jr.n_coarse, jr.n_fine)
        assert ts == js
    assert (tr.n_coarse, tr.n_fine) == (16, 8)


def test_unported_options_raise():
    conf = small_flagship()
    conf.put("renderer.type", "yolo")
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        make_renderer(conf, device="cpu")
    conf = small_flagship()
    conf.put("renderer.early_terminate", 0.5)
    with pytest.raises(NotImplementedError, match="early_terminate"):
        make_renderer(conf, device="cpu")


def test_from_jax_variables_layouts(jax_side):
    _, _, v = jax_side
    sd = from_jax_variables(v)
    k = v["params"]["encoder"]["model"]["conv1"]["kernel"]  # HWIO
    np.testing.assert_array_equal(sd["encoder.model.conv1.weight"].numpy(),
                                  np.transpose(k, (3, 2, 0, 1)))
    d = v["params"]["mlp_fine"]["lin_z_2"]["kernel"]  # (in, out)
    np.testing.assert_array_equal(sd["mlp_fine.lin_z.2.weight"].numpy(), d.T)
    s = v["batch_stats"]["encoder"]["model"]["layer1_0"]["BatchNorm_1"]
    np.testing.assert_array_equal(
        sd["encoder.model.layer1.0.bn2.running_mean"].numpy(), s["mean"])
