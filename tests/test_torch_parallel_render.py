"""Ray-sharded renders of the port (parallel/render.py) on 4 CPU ranks
over gloo against the JAX package's ``bind_parallel`` on a 4-device
virtual mesh and against the port's 1-rank render, with the same weights
and the JAX render's draws over the padded global batch: the NeRF
flagship at test size (NS=2, a ray count that pads), the YOLO flagship at
test size, the empty inputs, the field split over 'model' on a (data 1,
rays 2, model 2) mesh on both routes, and synchronised BatchNorm over
'data' against one rank's statistics over the whole batch."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pixelnerf_yolo_torch.convert import from_jax_variables
from pixelnerf_yolo_tpu import parallel as jpar
from torch_dist import run_ranks
from torch_parity import (YOLO_FAR, YOLO_NEAR, jax_draws, jax_yolo_draws,
                          perturbed_variables, port_model, scene,
                          small_flagship, small_yolo, to_np, yolo_scene)

import torch_parallel_workers as workers

N_RAYS = 37  # pads to 40 on 4 ray shards, to 38 on 2
ATOL = 1e-5  # sharded render vs JAX's (tests/test_model_render.py)
TP_RTOL, TP_ATOL = 1e-4, 1e-5  # tensor-parallel render
BN_TOL = 1e-6  # synchronised batch statistics
GRAD_RTOL = 1e-5  # encoder gradient, relative to its max |gradient|


def _jax_nerf(conf, v, mesh, key, n_pad):
    from pixelnerf_yolo_tpu.models import make_model
    from pixelnerf_yolo_tpu.render import make_renderer
    from pixelnerf_yolo_tpu.utils.camera import gen_rays

    jm, jr = make_model(conf.get_config("model")), make_renderer(conf)
    images, poses, focal = scene(ns=2)
    jc = jm.encode(v, jnp.asarray(images), jnp.asarray(poses),
                   jnp.asarray(focal))
    rays = gen_rays(jnp.asarray(poses[0]), 8, 8, jnp.asarray(focal), 0.8,
                    1.8)
    rays = np.array(rays).reshape(1, -1, 8)[:, :N_RAYS]
    rp = jpar.bind_parallel(jr, jm, mesh=mesh, want_weights=False)
    out = jax.tree.map(np.asarray, rp(v, jc, jnp.asarray(rays), key))
    return rays, jax_draws(jr, key, n_pad), out


@pytest.fixture(scope="module")
def legs():
    """JAX's sharded renders and the inputs, then one 4-rank run of the
    port."""
    from pixelnerf_yolo_tpu.models import make_model as jmake_model
    from pixelnerf_yolo_tpu.render import make_renderer as jmake_renderer
    from pixelnerf_yolo_tpu.utils.camera import gen_rays_yolo

    conf = small_flagship()
    jm = jmake_model(conf.get_config("model"))
    v = perturbed_variables(jm, scene(ns=2)[0][0])
    key = jax.random.PRNGKey(1)
    rays, draws, ref = _jax_nerf(conf, v, jpar.make_mesh(n_devices=4), key,
                                 40)
    tp_mesh = jpar.make_train_mesh(n_devices=4, batch_size=1,
                                   model_parallel=2)
    tp_ref, tp_draws = {}, None
    for route in ("false", "true"):
        c = small_flagship(use_fused_mlp=route)
        _, tp_draws, tp_ref[route] = _jax_nerf(c, v, tp_mesh, key, 38)
    one_dev = _jax_nerf(small_flagship(use_fused_mlp="true"), v,
                        jpar.make_mesh(n_devices=1), key, 37)[2]

    yconf = small_yolo()
    yjm = jmake_model(yconf.get_config("model"))
    images, poses, focal, c, target = yolo_scene(ns=3)
    yv = perturbed_variables(yjm, images[0], encoder_stats=True)
    yjc = yjm.encode(yv, jnp.asarray(images), jnp.asarray(poses),
                     jnp.asarray(focal), c=jnp.asarray(c))
    yrays = np.array(gen_rays_yolo(jnp.asarray(target), 8, 8,
                                   jnp.asarray(focal[0] / 8),
                                   jnp.asarray(c[0] / 8), YOLO_NEAR,
                                   YOLO_FAR)).reshape(-1, 8)[:N_RAYS]
    yjr = jmake_renderer(yconf)
    ykey = jax.random.PRNGKey(3)
    yref = np.asarray(jpar.bind_parallel(
        yjr, yjm, mesh=jpar.make_mesh(n_devices=4))(
            yv, yjc, jnp.asarray(yrays), ykey))
    yu = jax_yolo_draws(ykey, 40, yjr.n_coarse)

    rng = np.random.default_rng(0)
    s0, s1 = scene(ns=2, seed=0), scene(ns=2, seed=1)
    bn_scenes = (np.concatenate([s0[0], s1[0]]),
                 np.concatenate([s0[1], s1[1]]), s0[2])
    state = {k: t.numpy() for k, t in from_jax_variables(v).items()}
    spec = {
        "nerf_conf": conf.to_dict(), "nerf_state": state,
        "scene": scene(ns=2), "nerf_rays": rays, "nerf_draws": draws,
        "tp_states": {"false": state, "true": state}, "tp_draws": tp_draws,
        "yolo_conf": yconf.to_dict(),
        "yolo_state": {k: t.numpy()
                       for k, t in from_jax_variables(yv).items()},
        "yolo_scene": (images, poses, focal, c), "yolo_rays": yrays,
        "yolo_u": yu,
        "bn_x": rng.normal(size=(4, 8, 6, 5)).astype(np.float32) * 3 + 1,
        "bn_scenes": bn_scenes,
        "bn_g": rng.normal(size=(4, 16 * 16, 128)).astype(np.float32),
    }
    out = run_ranks(4, workers.render_leg, spec)
    refs = {"nerf": ref, "tp": tp_ref, "one_dev_fused": one_dev,
            "yolo": yref, "v": v, "yv": yv}
    return spec, refs, out


def _close(got, ref, **tol):
    for p in ref:
        for k in ("rgb", "depth"):
            np.testing.assert_allclose(got[p][k], ref[p][k], err_msg=p + k,
                                       **tol)


def test_nerf_matches_jax(legs):
    _, refs, out = legs
    assert out["nerf"]["coarse"]["rgb"].shape == (1, N_RAYS, 3)
    _close(out["nerf"], refs["nerf"], atol=ATOL, rtol=0)


def test_nerf_matches_one_rank(legs):
    """The port's 1-rank render with the padded draws' first N_RAYS rows:
    the ranks render each ray as one rank does."""
    spec, _, out = legs
    conf = small_flagship()
    tm = port_model(conf, legs[1]["v"])
    from pixelnerf_yolo_torch.render import make_renderer

    draws = {k: v[:N_RAYS] for k, v in spec["nerf_draws"].items()}
    with torch.no_grad():
        one = make_renderer(conf, device="cpu")(
            tm, tm.encode(*spec["scene"]), spec["nerf_rays"], draws=draws)
    _close(out["nerf"], jax.tree.map(to_np, one), atol=1e-6, rtol=0)


def test_yolo_matches_jax_and_one_rank(legs):
    spec, refs, out = legs
    assert out["yolo"].shape == refs["yolo"].shape == (N_RAYS, 3, 7)
    np.testing.assert_allclose(out["yolo"], refs["yolo"], atol=ATOL, rtol=0)
    conf = small_yolo()
    tm = port_model(conf, refs["yv"])
    from pixelnerf_yolo_torch.render import make_renderer

    images, poses, focal, c = spec["yolo_scene"]
    one = make_renderer(conf, device="cpu")(
        tm, tm.encode(images, poses, focal, c=c), spec["yolo_rays"],
        u=spec["yolo_u"][:N_RAYS])
    np.testing.assert_allclose(out["yolo"], to_np(one), atol=1e-6, rtol=0)


def test_empty_rays_match_jax(legs):
    """JAX's empty returns: NeRF (rgb (0, 3), depth (0,)), YOLO (0, A, 7)."""
    _, _, out = legs
    assert out["nerf_empty"] == [(0, 3), (0,)]
    assert out["yolo_empty"] == (0, 3, 7)


@pytest.mark.parametrize("route", ["false", "true"])
def test_tensor_parallel_render_matches_jax(legs, route):
    """(data 1, rays 2, model 2): the plain route's split blocks, and the
    kernel route (whole weights gathered over 'model'; on the CPU the
    kernels' plain twins) against JAX's tp_shardings render."""
    _, refs, out = legs
    _close(out["tp_" + route], refs["tp"][route], rtol=TP_RTOL,
           atol=TP_ATOL)
    # each rank holds H/2 of fc_0's rows and of fc_1's columns
    for shapes in out["tp_shapes"]:
        assert shapes["mlp_coarse.blocks.0.fc_0.weight"] == (32, 64)
        assert shapes["mlp_coarse.blocks.0.fc_0.bias"] == (32,)
        assert shapes["mlp_coarse.blocks.0.fc_1.weight"] == (64, 32)


def test_jax_fused_tp_render_matches_its_one_device_render(legs):
    """JAX's own check: its sharded TP render with use_fused_mlp = true
    (the Pallas kernels in interpret mode on the CPU, their operands
    sharded) gives its 1-device render's numbers on the 37 real rays,
    within the TP bar; the draws differ only in the padded rows."""
    _, refs, _ = legs
    _close(refs["tp"]["true"], refs["one_dev_fused"], rtol=TP_RTOL,
           atol=TP_ATOL)


def test_synced_batch_norm_statistics(legs):
    spec, _, out = legs
    var, mean = torch.var_mean(torch.as_tensor(spec["bn_x"]),
                               dim=(0, 2, 3), unbiased=False)
    np.testing.assert_allclose(out["bn_mean"], mean.numpy(), atol=BN_TOL,
                               rtol=0)
    np.testing.assert_allclose(out["bn_var"], var.numpy(), atol=BN_TOL,
                               rtol=BN_TOL)


def test_synced_batch_norm_encoder_gradient(legs):
    """A train-mode encode of 2 scenes split over 'data' (each rank one
    scene), its gradients summed over the data group, against one rank
    encoding both: the gradient within 1e-5 of its max, the running
    statistics within 1e-6."""
    spec, refs, out = legs
    tm = port_model(small_flagship(), refs["v"])
    cond = tm.encode(*spec["bn_scenes"], train=True)
    (cond.latent_flat.float() * torch.as_tensor(spec["bn_g"])).sum() \
        .backward()
    assert out["bn_grads"]
    for k, g in out["bn_grads"].items():
        ref = dict(tm.encoder.named_parameters())[k].grad.numpy()
        assert np.abs(g - ref).max() <= GRAD_RTOL * np.abs(ref).max(), k
    stats = {k: v.numpy() for k, v in tm.encoder.state_dict().items()
             if "running" in k}
    assert set(stats) == set(out["bn_stats"])
    for k, v in stats.items():
        np.testing.assert_allclose(out["bn_stats"][k], v, atol=BN_TOL,
                                   rtol=BN_TOL, err_msg=k)
