"""The port's encoder options against the JAX package on the CPU, f32, with
the same weights (``convert.from_jax_variables``) and numpy-seeded
inputs: the ResNet trunk's norm types, the conv encoder (``backbone =
conv``), the global ImageEncoder and ``index_global``, ``feature_scale``
below and above 1, ``norm_type`` in a conf, which both packages ignore, and
the global encoder's train-mode gradient against an f64 evaluation."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pixelnerf_yolo_tpu.models.encoder import (ImageEncoder as JImage,
                                                SpatialEncoder as JSpatial,
                                                index_global as jindex_global)
from pixelnerf_yolo_tpu.nn.resnet import ResNetFeatures as JResNet
from pixelnerf_yolo_torch.convert import from_jax_variables
from pixelnerf_yolo_torch.models.encoder import (ImageEncoder, SpatialEncoder,
                                                 index_global, make_encoder)
from pixelnerf_yolo_torch.nn.resnet import ResNetFeatures, group_norm
from torch_parity import (one_torch_thread, perturbed_variables,  # noqa: F401
                          renders_both, scene, small_flagship)

FWD_TOL = 2e-5
RENDER_TOL = 1e-4


def _images(n=2, size=32, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, size, size, 3)).astype(np.float32).clip(-1, 1)


def _moved(v, seed=0):
    """Every parameter and statistic moved off its init (scales and
    variances kept positive)."""
    def pert(path, x):
        ks = jax.tree_util.keystr(path)
        k = jax.random.PRNGKey(sum(map(ord, ks)) + seed)
        if ks.endswith("['var']") or ks.endswith("['scale']"):
            return x * jax.random.uniform(k, x.shape, minval=0.5, maxval=1.5)
        return x + 0.1 * jax.random.normal(k, x.shape)
    return jax.tree.map(np.asarray, jax.tree_util.tree_map_with_path(pert, v))


def _port_state(params, stats):
    """The port state_dict of a JAX trunk's (ResNet or conv encoder)
    params and batch statistics."""
    sd = from_jax_variables({"params": {"encoder": {"model": params}},
                             "batch_stats": {"encoder": {"model": stats}}})
    return {k[len("encoder.model."):]: t for k, t in sd.items()}


@pytest.mark.parametrize("norm_type", ["batch", "instance", "group", "none"])
def test_resnet_norm_types(norm_type):
    """ResNet-18 (3 taps) with each norm, JAX ``make_norm`` against the
    port's, every tap to 2e-5 x max(1, max|tap|)."""
    x = _images()
    jnet = JResNet(backbone="resnet18", num_layers=3, norm_type=norm_type)
    v = _moved(jnet.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    refs = jnet.apply(v, jnp.asarray(x))
    net = ResNetFeatures("resnet18", 3, norm_type=norm_type)
    net.load_state_dict(_port_state(v["params"], v.get("batch_stats", {})),
                        strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2), torch.float32)
    assert len(got) == len(refs) == 3
    for g, r in zip(got, refs):
        r = np.asarray(r).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(g.numpy(), r, atol=FWD_TOL * max(
            1.0, np.abs(r).max()))
    n_norm_params = sum(1 for k in net.state_dict() if ".bn" in k or
                        k.startswith("bn"))
    assert (n_norm_params > 0) == (norm_type in ("batch", "group"))


def test_group_norm_variance_against_f64():
    """The port's GroupNorm statistics (``torch.var_mean``) against an f64
    reference on a map with a large mean, where E[x^2] - E[x]^2 cancels;
    and flax's on the same map, for the record of how far it strays."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(2, 64, 9, 9)) * 0.05 + 30.0).astype(np.float32)
    m = torch.nn.GroupNorm(32, 64, eps=1e-6)
    with torch.no_grad():
        got = group_norm(torch.from_numpy(x), m, torch.float32).numpy()
    x64 = x.astype(np.float64).reshape(2, 32, -1)
    ref = ((x64 - x64.mean(-1, keepdims=True))
           / np.sqrt(x64.var(-1, keepdims=True) + 1e-6)).reshape(x.shape)
    err = np.abs(got - ref).max()
    assert err < 1e-3, err
    import flax.linen as fnn

    gn = fnn.GroupNorm(num_groups=32)
    xh = jnp.asarray(x.transpose(0, 2, 3, 1))
    flax_out = np.asarray(gn.apply(gn.init(jax.random.PRNGKey(0), xh), xh))
    flax_err = np.abs(flax_out.transpose(0, 3, 1, 2) - ref).max()
    assert err <= flax_err


def _spatial_pair(**kw):
    """A JAX SpatialEncoder with moved variables and the port's with its
    weights."""
    x = _images(size=kw.pop("size", 32))
    jenc = JSpatial(pretrained=False, **kw)
    v = _moved(jenc.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    ref = np.asarray(jenc.apply(v, jnp.asarray(x)))
    enc = SpatialEncoder(**kw)
    enc.model.load_state_dict(_port_state(
        v["params"]["model"], v.get("batch_stats", {}).get("model", {})),
        strict=True)
    with torch.no_grad():
        got = enc(torch.from_numpy(x)).numpy()
    return got, ref


def test_conv_encoder():
    """backbone = conv: the 128-d map at half resolution."""
    got, ref = _spatial_pair(backbone="conv", size=64)
    assert got.shape == ref.shape == (2, 32, 32, 128)
    np.testing.assert_allclose(got, ref, atol=FWD_TOL * max(
        1.0, np.abs(ref).max()))


def test_conv_encoder_from_conf_is_f32():
    """make_encoder builds the conv encoder; in a bf16 model it still runs
    in f32, as the JAX package's does."""
    conf = small_flagship(compute_dtype="bfloat16")
    conf.put("model.encoder.backbone", "conv")
    enc = make_encoder(conf.get_config("model.encoder"),
                       dtype=torch.bfloat16)
    assert enc.latent_size == 128
    with torch.no_grad():
        out = enc(torch.from_numpy(_images(1, 32)))
    assert out.dtype == torch.float32 and out.shape == (1, 16, 16, 128)


@pytest.mark.parametrize("feature_scale", [0.5, 2.0])
def test_feature_scale(feature_scale):
    got, ref = _spatial_pair(backbone="resnet18", num_layers=2,
                             feature_scale=feature_scale)
    side = int(32 * feature_scale) // 2
    assert got.shape == ref.shape == (2, side, side, 128)
    np.testing.assert_allclose(got, ref, atol=FWD_TOL * max(
        1.0, np.abs(ref).max()))


@pytest.mark.parametrize("latent_size", [128, 512])
def test_image_encoder_and_index_global(latent_size):
    """The global encoder (fc only below 512) and its broadcast."""
    x = _images()
    jenc = JImage(backbone="resnet18", pretrained=False,
                  latent_size=latent_size)
    v = _moved(jenc.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    ref = np.asarray(jenc.apply(v, jnp.asarray(x)))
    # (the same trunk stands in for the spatial encoder, which a model has)
    sd = from_jax_variables({
        "params": {"encoder": v["params"], "global_encoder": v["params"]},
        "batch_stats": {"encoder": v["batch_stats"],
                        "global_encoder": v["batch_stats"]}})
    enc = ImageEncoder("resnet18", latent_size)
    enc.load_state_dict({k[len("global_encoder."):]: t for k, t in sd.items()
                         if k.startswith("global_encoder.")}, strict=True)
    assert (enc.fc is None) == (latent_size == 512)
    with torch.no_grad():
        got = enc(torch.from_numpy(x))
    assert got.shape == ref.shape == (2, latent_size)
    np.testing.assert_allclose(got.numpy(), ref, atol=FWD_TOL * max(
        1.0, np.abs(ref).max()))
    np.testing.assert_array_equal(
        index_global(got, 5).numpy(),
        np.asarray(jindex_global(jnp.asarray(got.numpy()), 5)))


def test_norm_type_in_conf_renders_as_jax():
    """Neither package's SpatialEncoder.from_conf reads encoder.norm_type:
    a conf that sets it builds BatchNorm in both, and renders alike."""
    from pixelnerf_yolo_tpu.models import make_model as jmake_model

    conf = small_flagship()
    conf.put("model.encoder.norm_type", "group")
    jm = jmake_model(conf.get_config("model"))
    images, _, _ = scene(ns=2)
    v = perturbed_variables(jm, images[0])
    assert "BatchNorm_0" in v["params"]["encoder"]["model"]
    ref, got = renders_both(conf, v, ns=2)
    for p in ("coarse", "fine"):
        for k in ("rgb", "depth"):
            np.testing.assert_allclose(got[p][k], ref[p][k], atol=RENDER_TOL,
                                       err_msg=f"{p}.{k}")


@pytest.mark.parametrize("n_images", [4])
def test_global_encoder_train_gradient(n_images):
    """The global encoder's train-mode gradient (64 px, so its last map is
    2x2 and each BatchNorm channel of it sees 16 values), of a random
    linear functional of its latent: the port's f32 against its own f64
    evaluation within 1e-3 x max|g| per tensor, and no further from it
    than the JAX package's f32 gradient is (with 1e-5 of slack)."""
    import pixelnerf_yolo_torch.nn.resnet as port_resnet

    rng = np.random.default_rng(0)
    x = rng.normal(size=(n_images, 64, 64, 3)).astype(np.float32)
    w = rng.normal(size=(n_images, 32)).astype(np.float32)
    jenc = JImage(backbone="resnet18", pretrained=False, latent_size=32)
    v = jenc.init(jax.random.PRNGKey(0), jnp.asarray(x))

    def loss(p):
        out, _ = jenc.apply({"params": p, "batch_stats": v["batch_stats"]},
                            jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
        return jnp.sum(out * w)

    def port_sd(params):
        sd = from_jax_variables({
            "params": {"encoder": params, "global_encoder": params},
            "batch_stats": {"encoder": v["batch_stats"],
                            "global_encoder": v["batch_stats"]}})
        return {k[len("global_encoder."):]: t for k, t in sd.items()
                if k.startswith("global_encoder.")}

    jgrad = port_sd(jax.grad(loss)(v["params"]))

    def batch_norm_f64(x, m, cdt, train=False, momentum=0.9):
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        mul = torch.rsqrt(var + m.eps) * m.weight
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + m.bias[:, None, None])

    grads = {}
    for dt in (torch.float32, torch.float64):
        enc = ImageEncoder("resnet18", 32)
        enc.load_state_dict(port_sd(v["params"]))
        enc = enc.to(dt)
        with pytest.MonkeyPatch.context() as mp:
            if dt == torch.float64:
                mp.setattr(port_resnet, "batch_norm", batch_norm_f64)
            feats = enc.model(torch.from_numpy(x).to(dt).permute(0, 3, 1, 2),
                              dt, True)
        out = enc.fc(feats[-1].mean(dim=(2, 3)))
        (out * torch.from_numpy(w).to(dt)).sum().backward()
        grads[dt] = {k: p.grad.double() for k, p in enc.named_parameters()}
    for k, ref in grads[torch.float64].items():
        scale = ref.abs().max().item()
        port_err = (grads[torch.float32][k] - ref).abs().max().item() / scale
        jax_err = (jgrad[k].double() - ref).abs().max().item() / scale
        assert port_err <= 1e-3, (k, port_err)
        assert port_err <= jax_err + 1e-5, (k, port_err, jax_err)
