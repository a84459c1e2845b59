"""One YOLO training update of the port against the JAX package's
``YOLOTrainer`` on the CPU: the same weights (``convert.from_jax_variables``),
the same batch, the same view choice (both trainers' numpy Generator
seeded seed + 1) and the same coarse draws (``jax.random``, split as the
JAX trainer splits its key), through the field kernels' route
(``use_fused_mlp = true``: the port's autograd Functions, JAX's
custom_vjps) and the plain route.  The JAX update is its trainer's own
jitted ``_build_update()``; its gradients come from the same loss assembly
under ``jax.grad``."""

import math

import numpy as np
import pytest
import torch

from pixelnerf_yolo_torch.convert import from_jax_variables
from synth_data import make_yolo_dataset
from torch_parity import jax_yolo_trainer, jax_yolo_update, port_yolo_trainer

LR = 1e-4
LOSS_RTOL = 1e-5  # each reported loss, relative
GRAD_TOL = 1e-4  # per tensor, relative to its max |gradient|
STAT_TOL = 1e-5  # BatchNorm running statistics, absolute


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_yolo")
    root = make_yolo_dataset(str(tmp / "data"), n_scenes=2, n_views=4,
                             img_size=64)
    from pixelnerf_yolo_torch.data import DataLoader, YOLODataset
    from pixelnerf_yolo_torch.config.hocon import parse_string
    from torch_parity import yolo_train_conf

    conf = yolo_train_conf(parse_string, True)
    val = YOLODataset(root, stage="val", z_near=1, z_far=13.0, conf=conf)
    return root, next(iter(DataLoader(val, batch_size=1)))


def _param_update_close(name, got, ref_new, ref_grad, old):
    """Adam's first step moves each parameter by about -lr * sign(g): where
    |g_jax| > 1e-3 max|g| the port's new value is within 1e-3 lr of JAX's;
    elsewhere (a gradient near 0 can take either sign) within 2 lr."""
    g = np.abs(ref_grad)
    big = g > 1e-3 * g.max()
    diff = np.abs(got - ref_new)
    assert diff[big].max(initial=0) <= 1e-3 * LR, name
    assert diff.max() <= 2 * LR * (1 + 1e-3), name
    assert np.abs(ref_new - old).max() > 0.5 * LR, name  # it moved


@pytest.mark.parametrize("fused", ["true", "false"])
def test_update_matches_jax(tmp_path, data, fused):
    """f32: the 5 reported losses, every parameter gradient, the updated
    parameters and the encoder's running statistics after one step."""
    root, batch = data
    jtr, v = jax_yolo_trainer(root, tmp_path, fused)
    ttr = port_yolo_trainer(root, tmp_path, v, fused)
    ref_losses, ref_grads, ref_vars, u = jax_yolo_update(jtr, batch)
    losses = ttr.train_step(batch, u=torch.from_numpy(u))
    got = np.array([float(losses[k]) for k in
                    ("t", "box_loss", "object_loss", "no_object_loss",
                     "class_loss")])
    np.testing.assert_allclose(got, ref_losses, rtol=LOSS_RTOL)

    old = from_jax_variables(v)
    ref_g = from_jax_variables({"params": ref_grads,
                                "batch_stats": v["batch_stats"]})
    ref_new = from_jax_variables(ref_vars)
    model = ttr.model
    for name, p in model.named_parameters():
        g = p.grad.numpy()
        scale = np.abs(ref_g[name].numpy()).max()
        assert np.abs(g - ref_g[name].numpy()).max() <= GRAD_TOL * scale, \
            name
        _param_update_close(name, p.detach().numpy(), ref_new[name].numpy(),
                            ref_g[name].numpy(), old[name].numpy())
    stats = {k: t for k, t in model.state_dict().items() if "running" in k}
    assert len(stats) == 2 * 5  # resnet18 with 2 layers: 5 BatchNorms
    for name, t in stats.items():
        np.testing.assert_allclose(t.numpy(), ref_new[name].numpy(),
                                   atol=STAT_TOL, rtol=0, err_msg=name)
        assert np.abs(ref_new[name].numpy() - old[name].numpy()).max() > 0


def test_freeze_enc_moves_only_the_field(tmp_path, data):
    """--freeze_enc: eval-mode BatchNorm and a detached latent; the
    encoder's parameters and running statistics stay, the field moves, and
    the losses equal a frozen JAX trainer's."""
    root, batch = data
    jtr, v = jax_yolo_trainer(root, tmp_path, "true", freeze_enc=True)
    ttr = port_yolo_trainer(root, tmp_path, v, "true", freeze_enc=True)
    ref_losses, _, _, u = jax_yolo_update(jtr, batch)
    before = {k: t.clone() for k, t in ttr.model.state_dict().items()}
    losses = ttr.train_step(batch, u=torch.from_numpy(u))
    np.testing.assert_allclose(float(losses["t"]), ref_losses[0],
                               rtol=LOSS_RTOL)
    after = ttr.model.state_dict()
    for name, t in before.items():
        if name.startswith("encoder."):
            assert torch.equal(t, after[name]), name
    assert all(p.grad is None for p in ttr.model.encoder.parameters())
    assert any(not torch.equal(t, after[name]) for name, t in before.items()
               if name.startswith("mlp_coarse."))


def test_eval_step_changes_nothing(tmp_path, data):
    root, batch = data
    _, v = jax_yolo_trainer(root, tmp_path, "true")
    ttr = port_yolo_trainer(root, tmp_path, v, "true")
    before = {k: t.clone() for k, t in ttr.model.state_dict().items()}
    losses = ttr.eval_step(batch)
    assert math.isfinite(float(losses["t"]))
    assert all(not t.requires_grad for t in losses.values())
    for name, t in ttr.model.state_dict().items():
        assert torch.equal(t, before[name]), name
    assert all(p.grad is None for p in ttr.model.parameters())


def _latent_grads(fused, xyz):
    """The latent table's gradient of <forward(cond, xyz), g> in JAX and
    in the port (f32, the small YOLO flagship, 3 source views)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from pixelnerf_yolo_tpu.models import make_model as jax_model
    from torch_parity import perturbed_variables, port_model, small_yolo
    from torch_parity import yolo_scene

    conf = small_yolo(use_fused_mlp=fused)
    jm = jax_model(conf.get_config("model"))
    images, poses, focal, c, _ = yolo_scene(ns=3)
    v = perturbed_variables(jm, images[0])
    vs = jax.tree.map(jnp.asarray, v)
    cond = jm.encode(vs, jnp.asarray(images), jnp.asarray(poses),
                     jnp.asarray(focal), c=jnp.asarray(c))
    rng = np.random.default_rng(0)
    vd = rng.normal(size=xyz.shape).astype(np.float32)
    g = rng.normal(size=xyz.shape[:2] + (21,)).astype(np.float32)

    def f(lat):
        out = jm.forward(vs, cond.replace(latent_flat=lat), jnp.asarray(xyz),
                         viewdirs=jnp.asarray(vd))
        return jnp.sum(out * g)

    ref = np.asarray(jax.grad(f)(cond.latent_flat))
    tm = port_model(conf, v)
    with torch.no_grad():
        tcond = tm.encode(images, poses, focal, c=c)
    lat = tcond.latent_flat.clone().requires_grad_(True)
    out = tm.forward(dataclasses.replace(tcond, latent_flat=lat),
                     torch.from_numpy(xyz), viewdirs=torch.from_numpy(vd))
    (out * torch.from_numpy(g)).sum().backward()
    return lat.grad.numpy(), ref


@pytest.mark.parametrize("fused", ["true", "false"])
@pytest.mark.parametrize("points", ["around", "on"])
def test_latent_grad_at_the_camera_plane(fused, points):
    """Samples at and behind source view 0's z = 0 plane (world z = 2):
    project_latent zeroes the latents at camera z >= 0, and the gather's
    backward must carry no NaN through their zero weights into the latent
    table's gradient.  "around": samples on both sides of the plane, none
    on it; the port's gradient equals JAX's.  "on": some exactly on it
    (uv = x / 0), three at x = y = 0 too (0 / 0).  There the JAX package's
    gradient is NaN at the table entries those samples gather; the port's
    is finite everywhere and equals JAX's wherever JAX's is finite."""
    rng = np.random.default_rng(1)
    xyz = np.concatenate([rng.uniform(-0.3, 0.3, (1, 24, 2)),
                          rng.uniform(1.0, 3.0, (1, 24, 1))], -1)
    xyz = xyz.astype(np.float32)
    if points == "on":
        xyz[0, :6, 2] = 2.0
        xyz[0, 6:9] = [0.0, 0.0, 2.0]
    got, ref = _latent_grads(fused, xyz)
    assert np.isfinite(got).all()
    finite = np.isfinite(ref)
    if points == "around":
        assert finite.all()
    else:
        assert not finite.all()
    assert np.abs(ref[finite]).max() > 0
    np.testing.assert_allclose(got[finite], ref[finite], rtol=0,
                               atol=2e-5 * np.abs(ref[finite]).max())


# bf16 update against JAX: both packages run the field in bf16 with f32
# accumulation, but not through the same latent gather (JAX's is a one-hot
# bf16 product, PERF.md §2: field values within 0.1), and the max over
# samples sends each ray's prob gradient to one sample, which a bf16
# rounding can move.  Held: each reported loss to 1e-2 relative (measured
# 1.3e-3 at most); each parameter's gradient to 0.1 relative L2 (measured
# 3.4e-2 at most) and all of them together to 5e-2 (1.6e-2); and the
# updated parameters where a gradient entry is above 1e-2 of its tensor's
# max: within 1e-2 lr of JAX's (Adam's first step, -lr sign(g)) for all
# but 1% of those entries (measured 0.28% off).
BF16_LOSS_RTOL, BF16_GRAD_TOL, BF16_GRAD_TOL_ALL, BF16_OFF = \
    1e-2, 0.1, 5e-2, 1e-2


def test_bf16_update_matches_jax(tmp_path, data):
    root, batch = data
    jtr, v = jax_yolo_trainer(root, tmp_path, "true", "bfloat16")
    ttr = port_yolo_trainer(root, tmp_path, v, "true", "bfloat16")
    ref_losses, ref_grads, ref_vars, u = jax_yolo_update(jtr, batch)
    losses = ttr.train_step(batch, u=torch.from_numpy(u))
    got = np.array([float(losses[k]) for k in
                    ("t", "box_loss", "object_loss", "no_object_loss",
                     "class_loss")])
    np.testing.assert_allclose(got, ref_losses, rtol=BF16_LOSS_RTOL)
    ref_g = from_jax_variables({"params": ref_grads,
                                "batch_stats": v["batch_stats"]})
    ref_new = from_jax_variables(ref_vars)
    num = den = 0.0
    off = big = 0
    for name, p in ttr.model.named_parameters():
        g, r = p.grad.numpy(), ref_g[name].numpy().astype(np.float64)
        err = np.linalg.norm(g - r) / np.linalg.norm(r)
        assert err <= BF16_GRAD_TOL, (name, err)
        num += ((g - r) ** 2).sum()
        den += (r ** 2).sum()
        sel = np.abs(r) > 1e-2 * np.abs(r).max()
        diff = np.abs(p.detach().numpy() - ref_new[name].numpy())
        off += int((diff[sel] > 1e-2 * LR).sum())
        big += int(sel.sum())
    assert np.sqrt(num / den) <= BF16_GRAD_TOL_ALL
    assert off <= BF16_OFF * big, (off, big)
