"""The test process's side of the sharded-update tests
(tests/test_torch_parallel_train_*.py): a JAX trainer on a virtual mesh
and its jitted update, the port's 1-rank update, and the case specs the
4 ranks run (tests/torch_parallel_workers.py::train_leg)."""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from pixelnerf_yolo_torch.convert import from_jax_variables
from pixelnerf_yolo_tpu import parallel as jpar
from torch_parity import (jax_draws, jax_yolo_draws, nerf_train_conf,
                          perturbed_variables, train_args, yolo_train_conf)

LOSS_RTOL = 2e-5  # reported losses (tests/test_sharded_trainer.py)
# post-Adam parameters: JAX's _tree_allclose (tests/test_sharded_trainer.py)
PARAM_RTOL, PARAM_ATOL = 1e-3, 2.5e-4


def jax_trainer(kind, root, tmp, mesh_batch, mp, fused, size, extra,
                puts=None):
    """A JAX trainer over a (data, rays[, model]) mesh of 4 virtual
    devices, with perturbed weights: (trainer, variables)."""
    from pixelnerf_yolo_tpu.config.hocon import parse_string
    from pixelnerf_yolo_tpu.data import get_split_dataset
    from pixelnerf_yolo_tpu.models import make_model
    from pixelnerf_yolo_tpu.render import make_renderer
    from pixelnerf_yolo_tpu.train import make_trainer

    if kind == "nerf":
        conf = nerf_train_conf(parse_string, fused, puts=puts)
        dset, val = get_split_dataset("srn", root, image_size=(size, size))[:2]
        ns = int(extra["nviews"])
    else:
        conf = yolo_train_conf(parse_string, fused, puts=puts)
        dset, val, _ = get_split_dataset("yolo", root, conf=conf)
        ns = 3
    jm, jr = make_model(conf.get_config("model")), make_renderer(conf)
    mesh = jpar.make_train_mesh(n_devices=4, batch_size=mesh_batch,
                                model_parallel=mp)
    args = train_args(tmp, "jax", **extra)
    jtr = make_trainer(args, conf, dset, val, jm, jr,
                       jpar.bind_parallel(jr, jm, mesh=mesh), [ns])
    v = perturbed_variables(jm, np.zeros((ns, 3, 32, 32), np.float32),
                            encoder_stats=True)
    jtr.variables = jax.tree.map(jnp.asarray, v)
    jtr.init_opt_state(jtr.variables["params"])
    return jtr, v


def jax_update(kind, jtr, batch):
    """One update of the JAX trainer's jitted ``_build_update`` (the
    variant its ``_assemble`` picks) with the draws of the first key its
    calc_losses would split off: (losses, new variables, draws over the
    padded global batch)."""
    _, sub = jax.random.split(jax.random.PRNGKey(2))  # seed + 2
    if kind == "nerf":
        *inputs, ss = jtr._assemble(batch, True, 0)
        SB, R = inputs[4].shape[:2]
        draws = jax_draws(jtr.renderer, sub, SB * R, train=True)
        tail = (jnp.float32(jtr._lr), sub)
    else:
        *inputs, n_real, ss = jtr._assemble(batch)
        SB, k, R = inputs[4].shape[:3]
        draws = jax_yolo_draws(sub, SB * k * R, jtr.renderer.n_coarse)
        tail = (jnp.float32(n_real), jnp.float32(jtr._lr), sub)
    inputs = [jnp.asarray(x) if x is not None else None for x in inputs]
    train_fn, _ = jtr._build_update(scene_sharded=ss)
    new_vars, jtr.opt_state, loss_dict = train_fn(
        jtr.variables, jtr.opt_state, *inputs, *tail)
    jtr.variables = new_vars
    losses = {k: float(v) for k, v in loss_dict.items()}
    return losses, jax.tree.map(np.array, new_vars), draws, ss


def port_trainer(kind, root, tmp, v, fused, size, extra, puts=None):
    """The port's 1-rank trainer on the CPU with the JAX weights."""
    from pixelnerf_yolo_torch.data import get_split_dataset
    from pixelnerf_yolo_torch.models import make_model
    from pixelnerf_yolo_torch.render import make_renderer
    from pixelnerf_yolo_torch.train import make_trainer

    conf = port_conf(kind, fused, puts)
    if kind == "nerf":
        dset, val = get_split_dataset("srn", root, image_size=(size, size))[:2]
        ns = int(extra["nviews"])
    else:
        dset, val, _ = get_split_dataset("yolo", root, conf=conf)
        ns = 3
    model = make_model(conf.get_config("model"), device="cpu")
    model.load_state_dict(from_jax_variables(v), strict=True)
    return make_trainer(train_args(tmp, "port", **extra), conf, dset, val,
                        model, make_renderer(conf, device="cpu"), [ns],
                        device="cpu")


def port_conf(kind, fused, puts=None):
    from pixelnerf_yolo_torch.config.hocon import parse_string

    if kind == "nerf":
        return nerf_train_conf(parse_string, fused, puts=puts)
    return yolo_train_conf(parse_string, fused, puts=puts)


def case_spec(kind, name, root, v, fused, batch, draws, mesh_batch, mp,
              size, extra, puts=None):
    """What the ranks need for one case."""
    return {"kind": kind, "name": name, "root": root,
            "conf": port_conf(kind, fused, puts).to_dict(),
            "state": {k: t.numpy() for k, t in from_jax_variables(v).items()},
            "batch": batch, "draws": draws if kind == "nerf" else None,
            "u": draws if kind == "yolo" else None,
            "mesh_batch": mesh_batch, "mp": mp, "size": size,
            "args": extra}


def check_close(name, got_losses, ref_losses, got_state, ref_state):
    """Losses within LOSS_RTOL, every parameter within JAX's post-Adam
    bound; ref_state a port state_dict (numpy)."""
    assert set(got_losses) == set(ref_losses), name
    for k in ref_losses:
        assert np.isfinite(got_losses[k])
        np.testing.assert_allclose(got_losses[k], ref_losses[k],
                                   rtol=LOSS_RTOL, err_msg=f"{name} {k}")
    assert set(got_state) == set(ref_state), name
    for k, ref in ref_state.items():
        np.testing.assert_allclose(got_state[k], ref, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=f"{name} {k}")


def state_np(state) -> dict:
    return {k: t.detach().float().numpy() for k, t in state.items()}
