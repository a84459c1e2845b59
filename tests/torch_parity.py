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


# -- YOLO training ---------------------------------------------------------


def train_args(tmp_path, name, **extra):
    """The trainers' argparse namespace (train/train.py's flags), with the
    run's directories under tmp_path."""
    import argparse
    import os

    args = argparse.Namespace(
        name=name, resume=False, gpu_id=[0],
        logs_path=str(tmp_path / "logs"),
        checkpoints_path=str(tmp_path / "checkpoints"),
        visual_path=str(tmp_path / "visuals"),
        epochs=1, lr=1e-4, gamma=1.0, ray_batch_size=32, batch_size=1,
        nviews="3", freeze_enc=None, no_bbox_step=100000, fixed_test=None,
        seed=0)
    for k, v in extra.items():
        setattr(args, k, v)
    for d in (os.path.join(args.checkpoints_path, name),
              os.path.join(args.visual_path, name), args.logs_path):
        os.makedirs(d, exist_ok=True)
    return args


def yolo_train_conf(parse, use_fused_mlp, compute_dtype="float32"):
    """The JAX package's dry-run YOLO trainer conf (resnet18 with 2 layers,
    d_hidden 64, 16 coarse samples, 16-ray chunks) through ``parse`` (either
    package's hocon); the JAX package's bf16 latent pre-projection off."""
    from __graft_entry__ import _DRYRUN_YOLO_CONF

    conf = parse(_DRYRUN_YOLO_CONF)
    conf.put("model.use_fused_mlp", use_fused_mlp)
    conf.put("model.compute_dtype", compute_dtype)
    conf.put("model.latent_preproject", False)
    return conf


def jax_yolo_trainer(root, tmp_path, use_fused_mlp, compute_dtype="float32",
                     freeze_enc=False):
    """A JAX YOLOTrainer on the dataset at root with perturbed weights
    (every MLP weight and the encoder's BatchNorm moved off its init)."""
    from pixelnerf_yolo_tpu.config.hocon import parse_string
    from pixelnerf_yolo_tpu.data import get_split_dataset
    from pixelnerf_yolo_tpu.models import make_model
    from pixelnerf_yolo_tpu.parallel import bind_parallel
    from pixelnerf_yolo_tpu.render import make_renderer
    from pixelnerf_yolo_tpu.train import make_trainer

    conf = yolo_train_conf(parse_string, use_fused_mlp, compute_dtype)
    dset, val_dset, _ = get_split_dataset("yolo", root, conf=conf)
    jm = make_model(conf.get_config("model"), stop_encoder_grad=freeze_enc)
    jr = make_renderer(conf)
    jtr = make_trainer(train_args(tmp_path, "jax"), conf, dset, val_dset, jm,
                       jr, bind_parallel(jr, jm, gpus=[0]), [3])
    v = perturbed_variables(jm, np.zeros((3, 3, 32, 32), np.float32),
                            encoder_stats=True)
    jtr.variables = jax.tree.map(jnp.asarray, v)
    jtr.init_opt_state(jtr.variables["params"])
    return jtr, v


def port_yolo_trainer(root, tmp_path, variables, use_fused_mlp,
                      compute_dtype="float32", freeze_enc=False, **extra):
    """The port's YOLOTrainer on the CPU with the JAX variables' weights."""
    from pixelnerf_yolo_torch.config.hocon import parse_string
    from pixelnerf_yolo_torch.convert import from_jax_variables
    from pixelnerf_yolo_torch.data import get_split_dataset
    from pixelnerf_yolo_torch.models import make_model
    from pixelnerf_yolo_torch.render import make_renderer
    from pixelnerf_yolo_torch.train import make_trainer

    conf = yolo_train_conf(parse_string, use_fused_mlp, compute_dtype)
    dset, val_dset, _ = get_split_dataset("yolo", root, conf=conf)
    model = make_model(conf.get_config("model"), device="cpu",
                       stop_encoder_grad=freeze_enc)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return make_trainer(train_args(tmp_path, "port", **extra), conf, dset,
                        val_dset, model, make_renderer(conf, device="cpu"),
                        [3], device="cpu")


def jax_yolo_update(jtr, batch):
    """One update of the JAX trainer's own jitted ``_build_update()`` on
    batch, with the view choice of its ``_rng`` and the coarse draws of the
    first key its calc_losses would split off.  Returns (reported losses
    (5,), parameter gradients, updated variables, coarse draws), the
    gradients from the same loss assembly as its compute_losses."""
    jm, jr, yl = jtr.model, jtr.renderer, jtr.yolo_loss
    A = jtr.num_anchors_per_scale
    (si, sp, focal, c, rays, tg, anc, n_real, _) = jtr._assemble(batch)
    _, sub = jax.random.split(jax.random.PRNGKey(2))  # seed + 2
    SB, k, R = rays.shape[:3]
    u = jax_yolo_draws(sub, SB * k * R, jr.n_coarse)
    variables = jtr.variables
    inputs = [jnp.asarray(x) for x in (si, sp, focal, c, rays, tg, anc)]

    def loss_fn(params):
        vs = {"params": params, "batch_stats": variables["batch_stats"]}
        cond = jm.encode(vs, *inputs[:3], c=inputs[3],
                         train=not jm.stop_encoder_grad)
        if not jm.stop_encoder_grad:
            cond = cond[0]
        r = jr(jm, vs, cond, inputs[4].reshape(SB, k * R, 8), sub)
        losses = jax.vmap(lambda a, b, an: jnp.stack(yl(a, b, an)))(
            r.reshape(SB * k, R, A, 7), inputs[5].reshape(SB * k, R, A, 6),
            jnp.broadcast_to(inputs[6][None], (SB, k, A, 2))
            .reshape(SB * k, A, 2))
        return jnp.sum(losses[:, 0]), jnp.sum(losses, axis=0) / n_real

    grads = jax.grad(loss_fn, has_aux=True)(variables["params"])[0]
    grads = jax.tree.map(np.array, grads)
    train_fn, _ = jtr._build_update()
    new_vars, jtr.opt_state, loss_dict = train_fn(
        variables, jtr.opt_state, *inputs, jnp.float32(n_real),
        jnp.float32(jtr._lr), sub)
    jtr.variables = new_vars
    losses = np.array([float(loss_dict[k]) for k in
                       ("t", "box_loss", "object_loss", "no_object_loss",
                        "class_loss")])
    return losses, grads, jax.tree.map(np.array, new_vars), u
