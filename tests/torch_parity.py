"""Shared helpers for the PyTorch port's parity tests: the same weights
and inputs, made from a seed with numpy, go through the JAX package and
through pixelnerf_yolo_torch on the CPU."""

from __future__ import annotations

import contextlib

import numpy as np
import pytest

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
    test size: d_hidden 64 and 16 coarse samples.  The bf16 latent-table
    pre-projection (both packages' default on the plain route) is switched
    off, so these tests hold the raw latent; tests/test_torch_serving.py
    holds the pre-projection."""
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
            # the output layer: a ResnetFC's lin_out, an ImplicitNet's last
            p = v["params"][m]
            out = "lin_out" if "lin_out" in p else max(
                p, key=lambda k: int(k.split("_")[1]))
            p[out]["bias"] = p[out]["bias"].at[3].set(8.0)
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


# The YOLO scene.  pixelnerf_yolo_torch/operating_points.py (whose scenes
# chip_smoke.py runs where JAX is absent) keeps its own copy of these
# numbers in yolo_scene(); a change here goes there too.
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


def jax_draws(renderer, key, n_rows, train=False):
    """The render's draws as the JAX NeRFRenderer makes them
    (render/nerf.py: split(rng, 5); u from k_fine, then split(k_fine));
    with train and noise_std > 0 also the standard normals of the sigma
    noise, from k_noise_c over the coarse samples and from k_noise_f over
    the fine pass's sorted union (the port scales them by noise_std)."""
    k_coarse, k_fine, k_fdepth, k_noise_c, k_noise_f = jax.random.split(
        key, 5)
    n_imp = renderer.n_fine - renderer.n_fine_depth
    k2, _ = jax.random.split(k_fine)
    draws = {
        "u_coarse": np.array(
            jax.random.uniform(k_coarse, (n_rows, renderer.n_coarse))),
        "u": np.array(jax.random.uniform(k_fine, (n_rows, n_imp))),
        "u_jitter": np.array(jax.random.uniform(k2, (n_rows, n_imp))),
        "noise_d": np.array(
            jax.random.normal(k_fdepth, (n_rows, renderer.n_fine_depth))),
    }
    if train and renderer.noise_std > 0:
        draws["noise_c"] = np.array(
            jax.random.normal(k_noise_c, (n_rows, renderer.n_coarse)))
        draws["noise_f"] = np.array(jax.random.normal(
            k_noise_f, (n_rows, renderer.n_coarse + renderer.n_fine)))
    return draws


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


def _put(conf, puts):
    for k, v in (puts or {}).items():
        conf.put(k, v)
    return conf


def yolo_train_conf(parse, use_fused_mlp, compute_dtype="float32",
                    puts=None):
    """The JAX package's dry-run YOLO trainer conf (resnet18 with 2 layers,
    d_hidden 64, 16 coarse samples, 16-ray chunks) through ``parse`` (either
    package's hocon); the bf16 latent pre-projection off (``puts`` may turn
    it on: tests/test_torch_serving.py); then the keys of ``puts`` set."""
    from __graft_entry__ import _DRYRUN_YOLO_CONF

    conf = parse(_DRYRUN_YOLO_CONF)
    conf.put("model.use_fused_mlp", use_fused_mlp)
    conf.put("model.compute_dtype", compute_dtype)
    conf.put("model.latent_preproject", False)
    return _put(conf, puts)


def jax_yolo_trainer(root, tmp_path, use_fused_mlp, compute_dtype="float32",
                     freeze_enc=False, puts=None):
    """A JAX YOLOTrainer on the dataset at root with perturbed weights
    (every MLP weight and the encoder's BatchNorm moved off its init)."""
    from pixelnerf_yolo_tpu.config.hocon import parse_string
    from pixelnerf_yolo_tpu.data import get_split_dataset
    from pixelnerf_yolo_tpu.models import make_model
    from pixelnerf_yolo_tpu.parallel import bind_parallel
    from pixelnerf_yolo_tpu.render import make_renderer
    from pixelnerf_yolo_tpu.train import make_trainer

    conf = yolo_train_conf(parse_string, use_fused_mlp, compute_dtype, puts)
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
                      compute_dtype="float32", freeze_enc=False, puts=None,
                      **extra):
    """The port's YOLOTrainer on the CPU with the JAX variables' weights."""
    from pixelnerf_yolo_torch.config.hocon import parse_string
    from pixelnerf_yolo_torch.convert import from_jax_variables
    from pixelnerf_yolo_torch.data import get_split_dataset
    from pixelnerf_yolo_torch.models import make_model
    from pixelnerf_yolo_torch.render import make_renderer
    from pixelnerf_yolo_torch.train import make_trainer

    conf = yolo_train_conf(parse_string, use_fused_mlp, compute_dtype, puts)
    dset, val_dset, _ = get_split_dataset("yolo", root, conf=conf)
    model = make_model(conf.get_config("model"), device="cpu",
                       stop_encoder_grad=freeze_enc)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return make_trainer(train_args(tmp_path, "port", **extra), conf, dset,
                        val_dset, model, make_renderer(conf, device="cpu"),
                        [3], device="cpu")


def param_update_close(name, got, ref_new, ref_grad, old, lr):
    """Adam's first step moves each parameter by about -lr * sign(g): where
    |g_jax| > 1e-3 max|g| the port's new value is within 1e-3 lr of JAX's;
    elsewhere (a gradient near 0 can take either sign) within 2 lr."""
    g = np.abs(ref_grad)
    big = g > 1e-3 * g.max()
    diff = np.abs(got - ref_new)
    assert diff[big].max(initial=0) <= 1e-3 * lr, name
    assert diff.max() <= 2 * lr * (1 + 1e-3), name
    assert np.abs(ref_new - old).max() > 0.5 * lr, name  # it moved


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


# -- NeRF training ---------------------------------------------------------

NERF_TRAIN_SCHEMA = """
loss { lambda_coarse = 1.0
       lambda_fine = 1.0
       rgb { use_l1 = False }
       rgb_fine { use_l1 = False } }
train { print_interval = 2
        save_interval = 10000
        backup_interval = 10000
        vis_interval = 10000
        eval_interval = 10000
        metric_interval = 10000
        accu_grad = 1
        num_epoch_repeats = 1 }
"""
NERF_TRAIN_SIZE = 32  # SRN views are read at this size


def nerf_train_conf(parse, use_fused_mlp, noise_std=0.0,
                    compute_dtype="float32", puts=None):
    """bench.py's train_nerf conf at test size through ``parse`` (either
    package's hocon): the small flagship (resnet18 with 2 layers, d_hidden
    64, 64 + 16 + 16 samples) over the dry-run trainer schema, MSE on both
    passes with lambda 1 and 1."""
    flag = small_flagship(compute_dtype=compute_dtype,
                          use_fused_mlp=use_fused_mlp)
    conf = parse(NERF_TRAIN_SCHEMA)
    for k in ("model", "renderer"):
        conf.put(k, flag.get_config(k).to_dict())
    conf.put("renderer.noise_std", noise_std)
    return _put(conf, puts)


def nerf_datasets(get_split_dataset, root, size=NERF_TRAIN_SIZE):
    """(train, val) SRN datasets at root, read at size x size."""
    return get_split_dataset("srn", root, image_size=(size, size))[:2]


def jax_nerf_trainer(root, tmp_path, use_fused_mlp, ns, noise_std=0.0,
                     puts=None, size=NERF_TRAIN_SIZE, **extra):
    """A JAX PixelNeRFTrainer on the SRN dataset at root (read at size)
    with perturbed weights (every MLP weight and the encoder's BatchNorm
    moved off its init); ns source views a step."""
    from pixelnerf_yolo_tpu.config.hocon import parse_string
    from pixelnerf_yolo_tpu.data import get_split_dataset
    from pixelnerf_yolo_tpu.models import make_model
    from pixelnerf_yolo_tpu.parallel import bind_parallel
    from pixelnerf_yolo_tpu.render import make_renderer
    from pixelnerf_yolo_tpu.train import make_trainer

    conf = nerf_train_conf(parse_string, use_fused_mlp, noise_std,
                           puts=puts)
    dset, val_dset = nerf_datasets(get_split_dataset, root, size)
    jm = make_model(conf.get_config("model"))
    jr = make_renderer(conf)
    args = train_args(tmp_path, "jax", nviews=str(ns), **extra)
    jtr = make_trainer(args, conf, dset, val_dset, jm, jr,
                       bind_parallel(jr, jm, gpus=[0]), [ns])
    v = perturbed_variables(
        jm, np.zeros((ns, 3, size, size), np.float32),
        encoder_stats=True)
    jtr.variables = jax.tree.map(jnp.asarray, v)
    jtr.init_opt_state(jtr.variables["params"])
    return jtr, v


def port_nerf_trainer(root, tmp_path, variables, use_fused_mlp, ns,
                      noise_std=0.0, puts=None, size=NERF_TRAIN_SIZE,
                      **extra):
    """The port's PixelNeRFTrainer on the CPU with the JAX variables'
    weights."""
    from pixelnerf_yolo_torch.config.hocon import parse_string
    from pixelnerf_yolo_torch.convert import from_jax_variables
    from pixelnerf_yolo_torch.data import get_split_dataset
    from pixelnerf_yolo_torch.models import make_model
    from pixelnerf_yolo_torch.render import make_renderer
    from pixelnerf_yolo_torch.train import make_trainer

    conf = nerf_train_conf(parse_string, use_fused_mlp, noise_std,
                           puts=puts)
    dset, val_dset = nerf_datasets(get_split_dataset, root, size)
    model = make_model(conf.get_config("model"), device="cpu")
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return make_trainer(train_args(tmp_path, "port", nviews=str(ns), **extra),
                        conf, dset, val_dset, model,
                        make_renderer(conf, device="cpu"), [ns],
                        device="cpu")


def jax_nerf_inputs(jtr, batch, is_train=True, global_step=0):
    """The JAX trainer's assembled batch (its ``_rng`` advances as its
    calc_losses would) and the render's draws from the first key its
    calc_losses would split off: (jnp inputs of its update, draws)."""
    (si, sp, focal, c, rays, rgb_gt, w, _) = jtr._assemble(
        batch, is_train, global_step)
    _, sub = jax.random.split(jax.random.PRNGKey(2))  # seed + 2
    SB, R = rays.shape[:2]
    draws = jax_draws(jtr.renderer, sub, SB * R, train=is_train)
    inputs = [jnp.asarray(x) if x is not None else None
              for x in (si, sp, focal, c, rays, rgb_gt, w)]
    return inputs, draws, sub


def jax_nerf_update(jtr, batch, global_step=0):
    """One update of the JAX trainer's own jitted ``_build_update()`` on
    batch.  Returns (losses {"rc", "rf", "t"}, parameter gradients from
    the same loss assembly under ``jax.grad``, updated variables, draws)."""
    from pixelnerf_yolo_tpu.losses.rgb import weighted_rgb_loss

    jm, jr = jtr.model, jtr.renderer
    inputs, draws, sub = jax_nerf_inputs(jtr, batch, True, global_step)
    si, sp, focal, c, rays, rgb_gt, w = inputs
    variables = jtr.variables

    def loss_fn(params):
        vs = {"params": params, "batch_stats": variables["batch_stats"]}
        cond = jm.encode(vs, si, sp, focal, c=c,
                         train=not jm.stop_encoder_grad)
        if not jm.stop_encoder_grad:
            cond = cond[0]
        out = jr(jm, vs, cond, rays, sub, want_weights=False, train=True)
        rc = weighted_rgb_loss(jtr.rgb_coarse_crit, out["coarse"]["rgb"],
                               rgb_gt, w)
        rf = weighted_rgb_loss(jtr.rgb_fine_crit, out["fine"]["rgb"],
                               rgb_gt, w)
        return rc * jtr.lambda_coarse + rf * jtr.lambda_fine

    grads = jax.tree.map(np.array, jax.grad(loss_fn)(variables["params"]))
    train_fn, _ = jtr._build_update()
    new_vars, jtr.opt_state, loss_dict = train_fn(
        variables, jtr.opt_state, *inputs, jnp.float32(jtr._lr), sub)
    jtr.variables = new_vars
    losses = {k: float(v) for k, v in loss_dict.items()}
    return losses, grads, jax.tree.map(np.array, new_vars), draws


# The ReLU's derivative where its input is within KINK of 0, in both
# packages, for the NeRF training comparisons (``ramp_relu_grad``).
KINK = 1e-3


def ramp_relu_grad(monkeypatch):
    """Both packages' ResnetFC ReLU with its forward unchanged and its
    derivative a ramp, clip(0.5 + x / (2 KINK), 0, 1), instead of a step
    at 0.

    The field's pre-activations differ between the packages by f32
    rounding, ~1e-6 to 1e-5 after the positional encoding (frequencies up
    to 48) scales the sample points' rounding.  Where one lies that close
    to 0, the step puts it on either side in either package and moves
    that row's whole contribution to one unit's gradient (4e-4 x max|g| in
    one tensor of a NeRF update).  Under the ramp the gradient is
    continuous in the inputs, so the rounding moves it by as little as it
    moves the forward, while every other entry keeps the ReLU's own
    derivative."""
    import pixelnerf_yolo_tpu.nn.resnetfc as jax_resnetfc
    import pixelnerf_yolo_torch.nn.resnetfc as port_resnetfc

    @jax.custom_jvp
    def jax_relu(x):
        return jax.nn.relu(x)

    @jax_relu.defjvp
    def _jvp(primals, tangents):
        (x,), (t,) = primals, tangents
        ramp = jnp.clip(0.5 + x / (2 * KINK), 0.0, 1.0).astype(t.dtype)
        return jax.nn.relu(x), t * ramp

    class PortReLU(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return torch.relu(x)

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensors
            return g * torch.clamp(0.5 + x / (2 * KINK), 0.0, 1.0).to(g.dtype)

    jax_act, port_act = jax_resnetfc._activation, port_resnetfc.activation
    monkeypatch.setattr(jax_resnetfc, "_activation",
                        lambda beta: jax_act(beta) if beta > 0 else jax_relu)
    monkeypatch.setattr(port_resnetfc, "activation",
                        lambda beta: port_act(beta) if beta > 0
                        else PortReLU.apply)


def renders_both(conf, variables, ns=2, n_rays=40, model=None):
    """The JAX render and the port's (CPU) of scene(ns)'s rays with the
    same weights (``model``, else ``port_model``) and draws: (JAX out,
    port out) as numpy trees, each {"coarse", "fine"} of rgb and depth."""
    from pixelnerf_yolo_tpu.models import make_model as jmake_model
    from pixelnerf_yolo_tpu.render import make_renderer as jmake_renderer
    from pixelnerf_yolo_tpu.utils.camera import gen_rays
    from pixelnerf_yolo_torch.render import make_renderer

    jm = jmake_model(conf.get_config("model"))
    images, poses, focal = scene(ns=ns)
    jc = jm.encode(variables, jnp.asarray(images), jnp.asarray(poses),
                   jnp.asarray(focal))
    rays = gen_rays(jnp.asarray(poses[0]), 8, 8, jnp.asarray(focal), 0.8,
                    1.8)
    rays = np.array(rays).reshape(1, -1, 8)[:, :n_rays]
    jr = jmake_renderer(conf)
    key = jax.random.PRNGKey(1)
    ref = jax.tree.map(np.asarray, jr(jm, variables, jc, jnp.asarray(rays),
                                      key))
    tm = model if model is not None else port_model(conf, variables)
    with torch.no_grad():
        tc = tm.encode(images, poses, focal)
        got = make_renderer(conf, device="cpu")(
            tm, tc, rays, draws=jax_draws(jr, key, n_rays))
    return ref, jax.tree.map(to_np, got)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one intra-op thread for a module's tests: beside the other
    test workers its default pool (a thread a core) oversubscribes the
    cores, as tests/test_torch_convergence.py found.  A test module that
    imports this fixture gets it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
