"""The port's remaining model configurations against the JAX package on
the CPU, f32, with the same weights (``convert.from_jax_variables``),
inputs and draws: the ImplicitNet field (``mlp.type = mlp``), the global
encoder (``use_global_encoder``), the conv encoder (``backbone = conv``),
``feature_scale``, and models without the spatial encoder
(``use_encoder = false``): the field forward and a whole render each
(tests/test_torch_train_options.py: a training update each); NDC rays;
and the kernel route's guards, which keep a global-encoder model (and one
without the encoder) on the plain route."""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pixelnerf_yolo_tpu.models import make_model as jmake_model
from pixelnerf_yolo_tpu.nn.mlp import ImplicitNet as JImplicitNet
from pixelnerf_yolo_tpu.utils.camera import gen_rays as jgen_rays
from pixelnerf_yolo_torch.convert import resnetfc_state_dict
from pixelnerf_yolo_torch.nn.mlp import ImplicitNet
from pixelnerf_yolo_torch.ops import field_mlp
from pixelnerf_yolo_torch.utils.camera import gen_rays
from torch_parity import (one_torch_thread, perturbed_variables,  # noqa: F401
                          port_model, renders_both, scene, small_flagship,
                          to_np)

FWD_TOL = 2e-5
RENDER_TOL = 1e-4

GLOBAL = {"model.use_global_encoder": True,
          "model.global_encoder": {"backbone": "resnet18",
                                   "pretrained": False,
                                   "latent_size": 32}}
IMPLICIT = {"model.mlp_coarse": {"type": "mlp", "dims": [64, 64, 64],
                                 "skip_in": [2], "combine_layer": 2},
            "model.mlp_fine": {"type": "mlp", "dims": [64, 64],
                               "beta": 5.0, "combine_layer": 1}}
# each model configuration the conf schema adds to the flagship's
OPTIONS = {
    "implicit": IMPLICIT,
    "global": GLOBAL,
    "conv": {"model.encoder.backbone": "conv"},
    "no_encoder": {"model.use_encoder": False},
    "feature_scale": {"model.encoder.feature_scale": 0.5},
}


def _conf(option, **kw):
    conf = small_flagship(**kw)
    for k, v in OPTIONS[option].items():
        conf.put(k, v)
    return conf


@pytest.fixture(scope="module")
def sides():
    """Per option: (JAX model, perturbed variables)."""
    out = {}
    images, _, _ = scene(ns=2)
    for option in OPTIONS:
        jm = jmake_model(_conf(option).get_config("model"))
        out[option] = (jm, perturbed_variables(jm, images[0]))
    return out


# -- ImplicitNet ----------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {},
    {"skip_in": (2,), "beta": 3.0},
    {"combine_layer": 2, "geometric_init": False},
])
def test_implicit_net_forward(rng, kw):
    d_in, d_latent, ns, b = 5, 7, 2, 6
    jnet = JImplicitNet(d_out=4, dims=(32, 32, 32), d_latent=d_latent, **kw)
    zx = rng.normal(size=(ns * b, d_latent + d_in)).astype(np.float32)
    v = jnet.init(jax.random.PRNGKey(0), jnp.asarray(zx))
    ref = np.asarray(jnet.apply(v, jnp.asarray(zx),
                                combine_inner_dims=(ns, b)))
    net = ImplicitNet(d_in, d_out=4, dims=(32, 32, 32), d_latent=d_latent,
                      **kw)
    net.load_state_dict(resnetfc_state_dict(v["params"]), strict=True)
    got = net(torch.from_numpy(zx), combine_inner_dims=(ns, b)).detach()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=FWD_TOL * max(
        1.0, np.abs(ref).max()))


def test_implicit_net_init_statistics():
    """The geometric init: each layer's weight std against its rule (and
    JAX's draw), the biases 0 and -radius_init."""
    d_in, widths = 64, (256, 256)
    g = torch.Generator().manual_seed(0)
    net = ImplicitNet(d_in, d_out=4, dims=widths, radius_init=0.3,
                      generator=g)
    jnet = JImplicitNet(d_out=4, dims=widths, radius_init=0.3)
    jv = jnet.init(jax.random.PRNGKey(0), jnp.zeros((2, d_in)))["params"]
    fan_in = [d_in, *widths]
    for i, f in enumerate(fan_in):
        lin = getattr(net, f"lin{i}")
        last = i == len(fan_in) - 1
        want = math.sqrt(math.pi / f) if last else math.sqrt(2.0 / f)
        std = lin.weight.std().item()
        jstd = float(np.std(jv[f"lin_{i}"]["kernel"]))
        n = lin.weight.numel()
        # a sample std is within ~4 / sqrt(2n) of the true one
        assert abs(std / want - 1) < 4 / math.sqrt(2 * n), (i, std, want)
        assert abs(jstd / want - 1) < 4 / math.sqrt(2 * n), (i, jstd, want)
        bias = -0.3 if last else 0.0
        assert torch.all(lin.bias == bias)
        np.testing.assert_array_equal(jv[f"lin_{i}"]["bias"],
                                      np.full(lin.bias.shape, bias,
                                              np.float32))


# -- models -----------------------------------------------------------------

@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("ns", [1, 2])
def test_forward_matches(sides, rng, option, ns):
    jm, v = sides[option]
    conf = _conf(option)
    tm = port_model(conf, v)
    images, poses, focal = scene(ns=ns)
    jc = jm.encode(v, jnp.asarray(images), jnp.asarray(poses),
                   jnp.asarray(focal))
    with torch.no_grad():
        tc = tm.encode(images, poses, focal)
    if option == "global":
        np.testing.assert_allclose(to_np(tc.global_latent),
                                   np.asarray(jc.global_latent), atol=FWD_TOL)
    xyz = (rng.normal(size=(1, 50, 3)) * 0.3).astype(np.float32)
    vd = rng.normal(size=(1, 50, 3)).astype(np.float32)
    for coarse in (True, False):
        ref = np.asarray(jm.forward(v, jc, jnp.asarray(xyz), coarse=coarse,
                                    viewdirs=jnp.asarray(vd)))
        with torch.no_grad():
            got = to_np(tm.forward(tc, torch.from_numpy(xyz), coarse=coarse,
                                   viewdirs=torch.from_numpy(vd)))
        assert got.shape == ref.shape == (1, 50, 4)
        np.testing.assert_allclose(got, ref, atol=FWD_TOL)


@pytest.mark.parametrize("option", list(OPTIONS))
def test_render_matches(sides, option):
    _, v = sides[option]
    ref, got = renders_both(_conf(option), v, ns=2)
    for p in ("coarse", "fine"):
        for k in ("rgb", "depth"):
            assert got[p][k].shape == ref[p][k].shape
            np.testing.assert_allclose(got[p][k], ref[p][k], atol=RENDER_TOL,
                                       err_msg=f"{p}.{k}")


@pytest.mark.parametrize("option", ["global", "no_encoder"])
def test_kernel_route_guards(sides, rng, option):
    """At use_fused_mlp = true a global-encoder model (whose MLP takes
    [global, spatial] latents the kernels do not) and a model without the
    encoder stay on the plain route, pre-project nothing, and match JAX
    (which applies the same guards)."""
    jm0, v = sides[option]
    conf = _conf(option, use_fused_mlp="true")
    jm = jmake_model(conf.get_config("model"))
    tm = port_model(conf, v)
    for ns in (1, 2):
        assert not tm._fuses(tm.mlp_coarse, ns)
        assert not tm._fuses(tm.mlp_fine, ns)
    bf = _conf(option, compute_dtype="bfloat16", use_fused_mlp="false")
    bf.put("model.mlp_fine", {"type": "empty"})
    assert not port_model(bf, {"params": {
        k: x for k, x in v["params"].items() if k != "mlp_fine"},
        "batch_stats": v["batch_stats"]})._preprojects(1)
    images, poses, focal = scene(ns=2)
    jc = jm.encode(v, jnp.asarray(images), jnp.asarray(poses),
                   jnp.asarray(focal))
    xyz = (rng.normal(size=(1, 40, 3)) * 0.3).astype(np.float32)
    vd = rng.normal(size=(1, 40, 3)).astype(np.float32)
    field_mlp.reset_launches()
    with torch.no_grad():
        tc = tm.encode(images, poses, focal)
        got = to_np(tm.forward(tc, torch.from_numpy(xyz),
                               viewdirs=torch.from_numpy(vd)))
    ref = np.asarray(jm.forward(v, jc, jnp.asarray(xyz),
                                viewdirs=jnp.asarray(vd)))
    np.testing.assert_allclose(got, ref, atol=FWD_TOL)
    assert sum(field_mlp.launches.values()) == 0


# -- NDC rays -----------------------------------------------------------------

@pytest.mark.parametrize("focal", [30.0, (28.0, 33.0)])
def test_ndc_rays(rng, focal):
    poses = np.stack([np.eye(4, dtype=np.float32)] * 2)
    poses[:, :3, 3] = rng.normal(size=(2, 3)) * 0.1
    poses[:, 2, 3] += 2.0
    ref = np.asarray(jgen_rays(jnp.asarray(poses), 12, 10,
                               jnp.asarray(focal, jnp.float32), 0.5, 3.0,
                               ndc=True))
    got = gen_rays(torch.from_numpy(poses), 12, 10, torch.tensor(focal),
                   0.5, 3.0, ndc=True).numpy()
    assert got.shape == ref.shape == (2, 10, 12, 8)
    np.testing.assert_allclose(got, ref, atol=1e-6)
    assert np.all(got[..., 6] == 0.0) and np.all(got[..., 7] == 1.0)
