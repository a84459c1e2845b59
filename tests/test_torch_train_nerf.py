"""One NeRF training update of the port against the JAX package's
``PixelNeRFTrainer`` on the CPU: the same weights
(``convert.from_jax_variables``), the same batch (two SRN scenes), the
same view and pixel choice (both trainers' numpy Generator seeded
seed + 1) and the same draws (``jax.random``, split as the JAX trainer
splits its key, the sigma noise included), through the field kernels'
route (``use_fused_mlp = true``: the port's autograd Functions, JAX's
custom_vjps with Pallas in interpret mode) and the plain route, at NS=1
(``full_pe``) and NS=2 (``pre_combine_pe`` + ``post_combine``), with bbox
sampling on and off and with and without sigma noise.  Every case has
depth samples, whose gradient reaches the sample points through the
coarse depth.  In both packages the field's ReLU takes a ramp for its
derivative within 1e-3 of 0 (``torch_parity.ramp_relu_grad``): the f32
rounding of the two forwards, scaled by the positional encoding, would
otherwise put a pre-activation on the other side of the step now and
then and move that row's whole contribution.  The JAX update is its trainer's own jitted
``_build_update()``; its gradients come from the same loss assembly under
``jax.grad``.  Then ``eval_step`` and ``vis_step`` against JAX's, and the
renderer's training path: the gradients through the depth samples and the
latent table, and the sigma noise."""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pixelnerf_yolo_torch.convert import from_jax_variables
from synth_data import make_srn_dataset
from torch_parity import (jax_draws, jax_nerf_inputs, jax_nerf_trainer,
                          jax_nerf_update, param_update_close,
                          perturbed_variables, port_model,
                          port_nerf_trainer, ramp_relu_grad,
                          small_flagship)

LR = 1e-4
LOSS_RTOL = 1e-5  # each reported loss, relative
GRAD_TOL = 1e-4  # per tensor, relative to its max |gradient|
STAT_TOL = 1e-5  # BatchNorm running statistics, absolute
RAYS = 24  # a scene's rays a step
NOISE = 0.5  # renderer.noise_std when the case has sigma noise


@pytest.fixture(autouse=True)
def _ramp(monkeypatch):
    ramp_relu_grad(monkeypatch)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """(SRN root, a train batch of its two scenes)."""
    from pixelnerf_yolo_torch.data import DataLoader, get_split_dataset
    from torch_parity import nerf_datasets

    tmp = tmp_path_factory.mktemp("train_nerf")
    root = str(tmp / "data" / "cars")
    for stage in ("train", "val", "test"):
        make_srn_dataset(root, stage=stage, n_objs=2, n_views=5, img_size=32)
    dset, _ = nerf_datasets(get_split_dataset, root)
    return root, next(iter(DataLoader(dset, batch_size=2)))


def _trainers(tmp_path, root, fused, ns, noise, **extra):
    extra.setdefault("ray_batch_size", RAYS)
    jtr, v = jax_nerf_trainer(root, tmp_path, fused, ns, noise, **extra)
    ttr = port_nerf_trainer(root, tmp_path, v, fused, ns, noise, **extra)
    return jtr, ttr, v


def _torch_draws(draws):
    return {k: torch.from_numpy(x) for k, x in draws.items()}


# (fused route, source views, bbox sampling, sigma noise): every value of
# each, every pair of route, views and bbox, and every pair with noise
CASES = [
    ("true", 1, True, 0.0),
    ("false", 1, False, NOISE),
    ("true", 2, False, NOISE),
    ("false", 2, True, 0.0),
    ("true", 1, True, NOISE),
    ("false", 2, False, 0.0),
]


@pytest.mark.parametrize("fused,ns,bbox,noise", CASES)
def test_update_matches_jax(tmp_path, data, fused, ns, bbox, noise):
    """f32: the 3 reported losses, every parameter gradient, the updated
    parameters and the encoder's running statistics after one step."""
    root, batch = data
    jtr, ttr, v = _trainers(tmp_path, root, fused, ns, noise,
                            no_bbox_step=100000 if bbox else 0)
    ref_losses, ref_grads, ref_vars, draws = jax_nerf_update(jtr, batch)
    assert ("noise_c" in draws) == (noise > 0)
    losses = ttr.train_step(batch, 0, draws=_torch_draws(draws))
    assert set(losses) == set(ref_losses) == {"rc", "rf", "t"}
    for k, ref in ref_losses.items():
        np.testing.assert_allclose(float(losses[k]), ref, rtol=LOSS_RTOL,
                                   err_msg=k)

    old = from_jax_variables(v)
    ref_g = from_jax_variables({"params": ref_grads,
                                "batch_stats": v["batch_stats"]})
    ref_new = from_jax_variables(ref_vars)
    model = ttr.model
    for name, p in model.named_parameters():
        g, r = p.grad.numpy(), ref_g[name].numpy()
        scale = np.abs(r).max()
        assert scale > 0, name
        assert np.abs(g - r).max() <= GRAD_TOL * scale, name
        param_update_close(name, p.detach().numpy(), ref_new[name].numpy(),
                           r, old[name].numpy(), LR)
    stats = {k: t for k, t in model.state_dict().items() if "running" in k}
    assert len(stats) == 2 * 5  # resnet18 with 2 layers: 5 BatchNorms
    for name, t in stats.items():
        np.testing.assert_allclose(t.numpy(), ref_new[name].numpy(),
                                   atol=STAT_TOL, rtol=0, err_msg=name)
        assert np.abs(ref_new[name].numpy() - old[name].numpy()).max() > 0


def test_eval_step_matches_jax(tmp_path, data):
    """eval_step: the losses of JAX's eval_fn (eval BatchNorm, no sigma
    noise, uniform pixels), and nothing in the model changes."""
    root, batch = data
    jtr, ttr, _ = _trainers(tmp_path, root, "true", 2, NOISE)
    inputs, draws, sub = jax_nerf_inputs(jtr, batch, is_train=False)
    assert "noise_c" not in draws
    _, eval_fn = jtr._build_update()
    ref = {k: float(x) for k, x in
           eval_fn(jtr.variables, *inputs, sub).items()}
    before = {k: t.clone() for k, t in ttr.model.state_dict().items()}
    losses = ttr.eval_step(batch, 0, draws=_torch_draws(draws))
    for k, r in ref.items():
        np.testing.assert_allclose(float(losses[k]), r, rtol=LOSS_RTOL,
                                   err_msg=k)
    assert all(not t.requires_grad for t in losses.values())
    for name, t in ttr.model.state_dict().items():
        assert torch.equal(t, before[name]), name
    assert all(p.grad is None for p in ttr.model.parameters())


def test_vis_step_psnr_matches_jax(tmp_path, data):
    """vis_step renders the same unseen view from the same source views
    (both trainers' Generators) with the same draws: the same PSNR."""
    root, batch = data
    jtr, ttr, _ = _trainers(tmp_path, root, "true", 2, NOISE)
    _, sub = jax.random.split(jax.random.PRNGKey(2))
    H, W = batch["images"].shape[-2:]
    draws = jax_draws(jtr.renderer, sub, H * W)
    _, ref = jtr.vis_step(batch, 0, idx=1)
    vis, vals = ttr.vis_step(batch, 0, idx=1, draws=_torch_draws(draws))
    assert vis.shape == (2 * H, 6 * W, 3)
    assert math.isfinite(vals["psnr"])
    assert abs(vals["psnr"] - ref["psnr"]) <= 1e-4


# -- the renderer's training path -------------------------------------------


@pytest.fixture(scope="module")
def render_setup():
    """The small flagship (NS=2, fused route) with perturbed weights, its
    JAX and port models and renderers, the encoded scene in both, and 16
    rays into it."""
    from pixelnerf_yolo_tpu.models import make_model as jax_model
    from pixelnerf_yolo_tpu.render import make_renderer as jax_renderer
    from pixelnerf_yolo_torch.render import make_renderer
    from torch_parity import scene

    conf = small_flagship(use_fused_mlp="true")
    conf.put("renderer.noise_std", NOISE)
    jm = jax_model(conf.get_config("model"))
    images, poses, focal = scene(ns=2)
    v = perturbed_variables(jm, images[0])
    vs = jax.tree.map(jnp.asarray, v)
    jcond = jm.encode(vs, jnp.asarray(images), jnp.asarray(poses),
                      jnp.asarray(focal))
    tm = port_model(conf, v)
    with torch.no_grad():
        tcond = tm.encode(images, poses, focal)
    rng = np.random.default_rng(3)
    # from about the source cameras' centre (z = 1.3), looking down -z as
    # they do
    origins = np.tile([0.0, 0.0, 1.3], (16, 1)) + rng.normal(
        scale=0.05, size=(16, 3))
    dirs = np.concatenate([rng.normal(scale=0.1, size=(16, 2)),
                           -np.ones((16, 1))], -1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rays = np.concatenate([origins, dirs, np.full((16, 1), 0.8),
                           np.full((16, 1), 1.8)], -1).astype(np.float32)
    tr = make_renderer(conf, device="cpu")
    return jm, vs, jcond, jax_renderer(conf), tm, tcond, tr, rays[None]


def test_depth_sample_gradient_matches_jax(render_setup):
    """The fine pass as a function of the coarse depth and the coarse
    latents (the depth samples around depth_c, the sort, the reused and
    the new latents, the field, the composite with sorted sigma noise):
    its gradients with respect to depth_c and the reused latents equal
    ``jax.grad`` of the JAX renderer's ``_fine_pass_reuse``."""
    from pixelnerf_yolo_tpu.ops.ray_sampling import (
        sample_fine_depth as jax_depth)
    from pixelnerf_yolo_torch.ops.ray_sampling import sample_fine_depth

    jm, vs, jcond, jr, tm, tcond, tr, rays = render_setup
    rays = rays[0]
    B, Kc, n_d = rays.shape[0], tr.n_coarse, tr.n_fine_depth
    rng = np.random.default_rng(5)
    z_c = np.sort(rng.uniform(0.8, 1.8, (B, Kc)), -1).astype(np.float32)
    depth_c = rng.uniform(1.0, 1.6, B).astype(np.float32)
    noise_d = rng.normal(size=(B, n_d)).astype(np.float32)
    noise_f = (NOISE * rng.normal(size=(B, Kc + n_d))).astype(np.float32)
    g_rgb = rng.normal(size=(B, 3)).astype(np.float32)
    g_depth = rng.normal(size=B).astype(np.float32)
    pts = rays[:, None, :3] + z_c[..., None] * rays[:, None, 3:6]

    def jax_f(d, lat):
        z = jnp.concatenate([jnp.asarray(z_c), jax_depth(
            jnp.asarray(rays), d, n_d, depth_std=tr.depth_std,
            noise=jnp.asarray(noise_d))], -1)
        _, rgb, depth = jr._fine_pass_reuse(
            jm, vs, jcond, jnp.asarray(rays), z, Kc, lat, 1, None, True,
            sigma_noise=jnp.asarray(noise_f))
        return jnp.sum(rgb * g_rgb) + jnp.sum(depth * g_depth)

    jlat = jm.project_latent(vs, jcond, jnp.asarray(pts.reshape(1, -1, 3)))
    ref_d, ref_lat = jax.grad(jax_f, argnums=(0, 1))(jnp.asarray(depth_c),
                                                     jlat)
    with torch.no_grad():
        lat = tm.project_latent(tcond, torch.from_numpy(
            pts.reshape(1, -1, 3)))
    d = torch.from_numpy(depth_c).requires_grad_(True)
    lat.requires_grad_(True)
    trays = torch.from_numpy(rays)
    z = torch.cat([torch.from_numpy(z_c), sample_fine_depth(
        trays, d, n_d, depth_std=tr.depth_std,
        noise=torch.from_numpy(noise_d))], -1)
    _, rgb, depth = tr._fine_pass_reuse(
        tm, tcond, trays, z, Kc, lat, 1,
        sigma_noise=torch.from_numpy(noise_f))
    ((rgb * torch.from_numpy(g_rgb)).sum()
     + (depth * torch.from_numpy(g_depth)).sum()).backward()
    for got, ref in ((d.grad, ref_d), (lat.grad, ref_lat)):
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=GRAD_TOL * np.abs(ref).max())


def test_training_render_matches_jax(render_setup):
    """The whole training render (coarse, importance and depth samples,
    fine pass, sigma noise in both passes) equals JAX's ``train=True``
    render, and its gradient with respect to the latent table equals
    ``jax.grad`` of it; ``__call__`` renders without noise and records no
    graph."""
    jm, vs, jcond, jr, tm, tcond, tr, rays = render_setup
    key = jax.random.PRNGKey(7)
    draws = jax_draws(jr, key, rays.shape[1], train=True)
    assert set(draws) >= {"noise_c", "noise_f"}
    rng = np.random.default_rng(6)
    g = {p: rng.normal(size=(1, rays.shape[1], 3)).astype(np.float32)
         for p in ("coarse", "fine")}

    def jax_f(lat):
        out = jr(jm, vs, jcond.replace(latent_flat=lat), jnp.asarray(rays),
                 key, train=True)
        return sum(jnp.sum(out[p]["rgb"] * g[p]) for p in g), out

    (_, ref_out), ref_grad = jax.value_and_grad(jax_f, has_aux=True)(
        jcond.latent_flat)
    lat = tcond.latent_flat.clone().requires_grad_(True)
    cond = dataclasses.replace(tcond, latent_flat=lat)
    out = tr.render(tm, cond, rays, draws=_torch_draws(draws), train=True)
    sum((out[p]["rgb"] * torch.from_numpy(g[p])).sum() for p in g).backward()
    for p in g:
        for k in ("rgb", "depth"):
            np.testing.assert_allclose(out[p][k].detach().numpy(),
                                       np.asarray(ref_out[p][k]), rtol=0,
                                       atol=1e-4, err_msg=(p, k))
    ref_grad = np.asarray(ref_grad)
    np.testing.assert_allclose(lat.grad.numpy(), ref_grad, rtol=0,
                               atol=GRAD_TOL * np.abs(ref_grad).max())
    # the noise moved the render; inference ignores it
    quiet = tr(tm, tcond, rays, draws=_torch_draws(draws))
    assert not quiet["fine"]["rgb"].requires_grad
    assert not torch.allclose(quiet["fine"]["rgb"], out["fine"]["rgb"])
    ref_quiet = jr(jm, vs, jcond, jnp.asarray(rays), key)
    np.testing.assert_allclose(quiet["fine"]["rgb"].numpy(),
                               np.asarray(ref_quiet["fine"]["rgb"]), rtol=0,
                               atol=1e-4)
