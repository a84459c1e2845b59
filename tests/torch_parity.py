"""Shared helpers for the PyTorch port's parity tests: the same weights
and inputs, made from a seed with numpy, go through the JAX package and
through pixelnerf_yolo_torch on the CPU."""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
import torch

from __graft_entry__ import _flagship


def small_flagship(compute_dtype="float32", use_fused_mlp=None):
    """The flagship conf at test size (d_hidden 64, resnet18, 2 layers)."""
    conf = _flagship(d_hidden=64, backbone="resnet18", num_layers=2,
                     compute_dtype=compute_dtype)
    if use_fused_mlp is not None:
        conf.put("model.use_fused_mlp", use_fused_mlp)
    return conf


def perturbed_variables(jmodel, images, seed=0):
    """JAX variables with signal in every MLP weight (fc_1 is zero-init)
    and a sigma bias that keeps the composite weights away from 0 and 1."""
    v = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(images))

    def pert(path, x):
        ks = jax.tree_util.keystr(path)
        if "mlp" not in ks:
            return x
        k = jax.random.PRNGKey(sum(map(ord, ks)) + seed)
        return x + 0.03 * jax.random.normal(k, x.shape)

    v = jax.tree_util.tree_map_with_path(pert, v)
    for m in ("mlp_coarse", "mlp_fine"):
        if m in v["params"]:
            b = v["params"][m]["lin_out"]["bias"]
            v["params"][m]["lin_out"]["bias"] = b.at[3].set(8.0)
    return jax.tree.map(np.asarray, v)


def scene(ns=2, size=32, seed=0):
    """(1, NS, 3, H, W) images, (1, NS, 4, 4) camera-to-world poses, focal."""
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(1, ns, 3, size, size)).astype(np.float32)
    images = images.clip(-1, 1)
    poses = np.stack([np.eye(4, dtype=np.float32) for _ in range(ns)])
    poses[:, 2, 3] = 1.3
    poses[:, 0, 3] = np.linspace(-0.1, 0.1, ns)
    return images, poses[None], np.float32(size * 0.9)


def port_model(conf, variables):
    from pixelnerf_yolo_torch.convert import from_jax_variables
    from pixelnerf_yolo_torch.models import make_model

    model = make_model(conf.get_config("model"), device="cpu")
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model


def jax_draws(renderer, key, n_rows):
    """The render's draws as the JAX NeRFRenderer makes them
    (render/nerf.py: split(rng, 5); u from k_fine, then split(k_fine))."""
    k_coarse, k_fine, k_fdepth, _, _ = jax.random.split(key, 5)
    n_imp = renderer.n_fine - renderer.n_fine_depth
    k2, _ = jax.random.split(k_fine)
    return {
        "u_coarse": np.array(
            jax.random.uniform(k_coarse, (n_rows, renderer.n_coarse))),
        "u": np.array(jax.random.uniform(k_fine, (n_rows, n_imp))),
        "u_jitter": np.array(jax.random.uniform(k2, (n_rows, n_imp))),
        "noise_d": np.array(
            jax.random.normal(k_fdepth, (n_rows, renderer.n_fine_depth))),
    }


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)
