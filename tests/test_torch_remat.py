"""``model.remat`` in the port (``torch.utils.checkpoint``, non-reentrant)
against the JAX package's ``jax.checkpoint`` and against the port without
remat: one f32 NeRF training update on the CPU for each remat_policy
(full, block, dots) and for remat_gather, through the field kernels' route
and the plain route; the remat chunk budget; the two construction errors;
a bf16 remat update.  Both packages' ReLU takes a ramp derivative within
1e-3 of 0 in the JAX comparisons (``torch_parity.ramp_relu_grad``)."""

import math

import numpy as np
import pytest
import torch

from pixelnerf_yolo_torch.convert import from_jax_variables
from synth_data import make_srn_dataset
from torch_parity import (jax_nerf_trainer, jax_nerf_update, port_model,
                          port_nerf_trainer, ramp_relu_grad, scene,
                          small_flagship)

LOSS_RTOL = 1e-5  # each reported loss against JAX, relative
GRAD_TOL = 1e-4  # per tensor against JAX, relative to its max |gradient|
SELF_LOSS_RTOL = 1e-6  # remat against no remat in the port
SELF_GRAD_TOL = 1e-5
RAYS = 24

# (remat_policy, remat_gather, fused route, source views)
CASES = [
    ("full", False, "true", 1),
    ("block", False, "false", 2),
    ("dots", False, "false", 1),
    ("", True, "true", 2),
]


def _puts(policy, gather, remat=True):
    return {"model.remat": remat, "model.remat_policy": policy,
            "model.remat_gather": gather}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from pixelnerf_yolo_torch.data import DataLoader, get_split_dataset
    from torch_parity import nerf_datasets

    tmp = tmp_path_factory.mktemp("remat")
    root = str(tmp / "data" / "cars")
    for stage in ("train", "val", "test"):
        make_srn_dataset(root, stage=stage, n_objs=2, n_views=5, img_size=32)
    dset, _ = nerf_datasets(get_split_dataset, root)
    return root, next(iter(DataLoader(dset, batch_size=2)))


@pytest.mark.parametrize("policy,gather,fused,ns", CASES)
def test_remat_update_matches_jax(tmp_path, data, monkeypatch, policy,
                                  gather, fused, ns):
    """The reported losses and every parameter gradient of one update
    against JAX's remat update with the same policy."""
    ramp_relu_grad(monkeypatch)
    root, batch = data
    puts = _puts(policy, gather)
    jtr, v = jax_nerf_trainer(root, tmp_path, fused, ns, puts=puts,
                              ray_batch_size=RAYS)
    ttr = port_nerf_trainer(root, tmp_path, v, fused, ns, puts=puts,
                            ray_batch_size=RAYS)
    assert jtr.model.remat and ttr.model.remat
    ref_losses, ref_grads, _, draws = jax_nerf_update(jtr, batch)
    losses = ttr.train_step(batch, 0, draws={
        k: torch.from_numpy(x) for k, x in draws.items()})
    for k, ref in ref_losses.items():
        np.testing.assert_allclose(float(losses[k]), ref, rtol=LOSS_RTOL,
                                   err_msg=k)
    ref_g = from_jax_variables({"params": ref_grads,
                                "batch_stats": v["batch_stats"]})
    for name, p in ttr.model.named_parameters():
        g, r = p.grad.numpy(), ref_g[name].numpy()
        scale = np.abs(r).max()
        assert scale > 0, name
        assert np.abs(g - r).max() <= GRAD_TOL * scale, name


def _port_step(root, tmp_path, v, fused, ns, batch, puts, name, dtype=None):
    if dtype is not None:
        puts = dict(puts, **{"model.compute_dtype": dtype})
    ttr = port_nerf_trainer(root, tmp_path / name, v, fused, ns, puts=puts,
                            ray_batch_size=RAYS)
    before = {k: p.detach().clone() for k, p in ttr.model.named_parameters()}
    losses = ttr.train_step(batch, 0)
    grads = {k: p.grad.clone() for k, p in ttr.model.named_parameters()}
    return ttr, {k: float(x) for k, x in losses.items()}, grads, before


@pytest.mark.parametrize("fused,ns", [("true", 1), ("false", 2)])
def test_remat_update_matches_no_remat(tmp_path, data, fused, ns):
    """Each policy and remat_gather against the port's own update without
    remat, with the same draws (both trainers' Generators)."""
    root, batch = data
    _, v = jax_nerf_trainer(root, tmp_path, fused, ns, ray_batch_size=RAYS)
    _, ref_losses, ref_grads, _ = _port_step(
        root, tmp_path, v, fused, ns, batch, _puts("", False, remat=False),
        "plain")
    for policy, gather, _, _ in CASES:
        ttr, losses, grads, _ = _port_step(
            root, tmp_path, v, fused, ns, batch, _puts(policy, gather),
            f"{policy}_{gather}")
        assert ttr.model.remat
        for k, ref in ref_losses.items():
            assert losses[k] == pytest.approx(ref, rel=SELF_LOSS_RTOL), k
        for name, r in ref_grads.items():
            scale = r.abs().max().item()
            assert (grads[name] - r).abs().max().item() \
                <= SELF_GRAD_TOL * scale, (policy, gather, name)


@pytest.mark.parametrize("fused,ns", [("true", 1), ("true", 2),
                                      ("false", 2)])
def test_remat_forward_equals_plain(fused, ns):
    """A remat forward (autograd on) gives the plain forward's values."""
    conf = small_flagship(use_fused_mlp=fused)
    images, poses, focal = scene(ns=ns)
    from pixelnerf_yolo_tpu.models import make_model as jax_model
    from torch_parity import perturbed_variables

    v = perturbed_variables(jax_model(conf.get_config("model")), images[0])
    plain = port_model(conf, v)
    conf.put("model.remat", True)
    remat = port_model(conf, v)
    rng = np.random.default_rng(0)
    xyz = torch.from_numpy(rng.normal(0, 0.2, (1, 50, 3)).astype(np.float32))
    vd = torch.from_numpy(rng.normal(size=(1, 50, 3)).astype(np.float32))
    outs = []
    for m in (plain, remat):
        cond = m.encode(images, poses, focal)
        outs.append(m.forward(cond, xyz, viewdirs=vd, coarse=False))
    assert outs[1].requires_grad
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("n_rays,ns,width", [(8192, 1, 512), (8192, 2, 512),
                                             (3000, 3, 1792), (40, 1, 512)])
def test_remat_chunk_budget_matches_jax(n_rays, ns, width):
    """Training with remat chunks at 2^19 rows and ignores
    eval_batch_size, as JAX's renderer does."""
    from pixelnerf_yolo_tpu.render import make_renderer as jax_renderer
    from pixelnerf_yolo_torch.render import make_renderer

    conf = small_flagship()
    conf.put("renderer.eval_batch_size", 1 << 22)
    jr, tr = jax_renderer(conf), make_renderer(conf, device="cpu")
    for grad_remat in (False, True):
        assert (tr._chunk_rays(n_rays, ns, width, grad_remat)
                == jr.chunk_rays_for(n_rays, ns, width, grad_remat))
    assert tr._chunk_rays(8192, 1, 512, True) < 8192


def test_remat_errors_match_jax():
    from pixelnerf_yolo_tpu.models import make_model as jax_model
    from pixelnerf_yolo_torch.models import make_model

    conf = small_flagship()
    conf.put("model.remat", True)
    conf.put("model.remat_policy", "everything")
    with pytest.raises(ValueError) as jerr:
        from pixelnerf_yolo_tpu.models.pixelnerf import _resolve_remat_policy
        _resolve_remat_policy("everything")
    with pytest.raises(ValueError) as terr:
        make_model(conf.get_config("model"), device="cpu")
    assert str(terr.value) == str(jerr.value)

    conf = small_flagship()
    conf.put("model.remat_gather", True)
    with pytest.raises(ValueError) as jerr:
        jax_model(conf.get_config("model"))
    with pytest.raises(ValueError) as terr:
        make_model(conf.get_config("model"), device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert "remat_gather requires" in str(terr.value)


@pytest.mark.parametrize("fused", ["true", "false"])
def test_remat_bf16_trains(tmp_path, data, fused):
    """bf16 with remat: one update gives finite losses and moves the
    field."""
    root, batch = data
    _, v = jax_nerf_trainer(root, tmp_path, fused, 2, ray_batch_size=RAYS)
    ttr, losses, grads, before = _port_step(
        root, tmp_path, v, fused, 2, batch, _puts("", False), "bf16",
        dtype="bfloat16")
    assert ttr.model.remat and ttr.model.compute_dtype == torch.bfloat16
    assert all(math.isfinite(x) for x in losses.values())
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    moved = [k for k, p in ttr.model.named_parameters()
             if k.startswith("mlp_coarse.")
             and not torch.equal(p.detach(), before[k])]
    assert moved
