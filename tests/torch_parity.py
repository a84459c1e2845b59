"""Shared helpers for the PyTorch port's parity tests: the same weights
and inputs, made from a seed with numpy, go through the JAX package and
through pixelnerf_yolo_torch on the CPU."""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
import torch

from __graft_entry__ import _flagship


def small_flagship(compute_dtype="float32", use_fused_mlp=None,
                   use_code_viewdirs=False, d_hidden=64):
    """The flagship conf at test size (d_hidden 64, resnet18, 2 layers)."""
    conf = _flagship(d_hidden=d_hidden, backbone="resnet18", num_layers=2,
                     compute_dtype=compute_dtype)
    conf.put("model.use_code_viewdirs", use_code_viewdirs)
    if use_fused_mlp is not None:
        conf.put("model.use_fused_mlp", use_fused_mlp)
    return conf


def small_yolo(compute_dtype="float32", use_fused_mlp=None, n_coarse=16):
    """The YOLO flagship conf (ELAN backbone at its full 1792-d output) at
    test size: d_hidden 64 and 16 coarse samples.  The JAX package's bf16
    latent-table pre-projection is switched off: the port has none."""
    conf = _flagship(d_hidden=64, backbone="custom", yolo=True,
                     compute_dtype=compute_dtype)
    conf.put("model.latent_preproject", False)
    conf.put("renderer.n_coarse", n_coarse)
    if use_fused_mlp is not None:
        conf.put("model.use_fused_mlp", use_fused_mlp)
    return conf


def perturbed_variables(jmodel, images, seed=0, encoder_stats=False):
    """JAX variables with signal in every MLP weight (fc_1 is zero-init)
    and, in NeRF mode, a sigma bias that keeps the composite weights away
    from 0 and 1.  encoder_stats also moves the encoder's BatchNorm
    scale, bias, mean and variance off their init."""
    v = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(images))

    def pert(path, x):
        ks = jax.tree_util.keystr(path)
        k = jax.random.PRNGKey(sum(map(ord, ks)) + seed)
        if "mlp" in ks:
            return x + 0.03 * jax.random.normal(k, x.shape)
        if encoder_stats and "BatchNorm" in ks:
            if ks.endswith("['var']") or ks.endswith("['scale']"):
                return x * jax.random.uniform(k, x.shape, minval=0.5,
                                              maxval=1.5)
            return x + 0.1 * jax.random.normal(k, x.shape)
        return x

    v = jax.tree_util.tree_map_with_path(pert, v)
    for m in ("mlp_coarse", "mlp_fine"):
        if m in v["params"] and not jmodel.yolo:
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


# The YOLO scene.  chip_smoke.py (which runs where JAX is absent) keeps its
# own copy of these numbers in yolo_scene(); a change here goes there too.
YOLO_NEAR, YOLO_FAR = 1.0, 3.0


def yolo_extrinsics(ns):
    """(NS, 4, 4) world-to-camera extrinsics around a target camera at the
    origin looking down +z, whose ray samples lie at world z in [near,
    far].  View 0 sits (near + far) / 2 behind it, so its samples lie on
    both sides of camera z = 0; views 1 and 2 are the target camera turned
    180 degrees about y (every sample at camera z < 0, where YOLO mode keeps
    the latent), the second moved sideways."""
    flip = np.diag([-1.0, 1.0, -1.0, 1.0]).astype(np.float32)
    views = [np.eye(4, dtype=np.float32), flip.copy(), flip.copy()]
    views[0][:3, 3] = [0.05, -0.03, -(YOLO_NEAR + YOLO_FAR) / 2]
    views[2][:3, 3] = [0.1, 0.05, 0.0]
    return np.stack(views[:ns])


def yolo_scene(ns=3, size=64, seed=0):
    """(1, NS, 3, H, W) images, (1, NS, 4, 4) extrinsics, focal (1, 2) and
    c (1, 2), and the target camera's (1, 4, 4) extrinsic."""
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(1, ns, 3, size, size)).astype(np.float32)
    focal = np.full((1, 2), size * 0.9, np.float32)
    c = np.full((1, 2), size / 2.0, np.float32)
    return (images.clip(-1, 1), yolo_extrinsics(ns)[None], focal, c,
            np.eye(4, dtype=np.float32)[None])


def jax_yolo_draws(key, n_rows, n_coarse):
    """The YoloRenderer's coarse draws as the JAX package makes them
    (render/yolo.py: sample_coarse(rng=key) over the flat batch)."""
    return np.array(jax.random.uniform(key, (n_rows, n_coarse)))


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
