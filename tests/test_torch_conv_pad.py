"""The port's SAME-padding helpers and conv-block factory
(pixelnerf_yolo_torch/utils/conv_pad.py) against the JAX package's
(pixelnerf_yolo_tpu/utils/conv_pad.py), on numpy-seeded inputs.  The
padding arithmetic and the pads and crops are exact; a conv block (a
product and a norm) is held to 2e-5."""

import numpy as np
import pytest

import flax.linen as fnn
import jax
import jax.numpy as jnp
import torch

from pixelnerf_yolo_tpu.utils import conv_pad as jcp
from pixelnerf_yolo_torch.utils import conv_pad as tcp

FWD_TOL = 2e-5


@pytest.mark.parametrize("shape", [(7, 9), (2, 3, 8, 8), (1, 16, 15)])
@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (4, 2), (7, 3), (1, 1)])
def test_calc_same_pad_conv2d(shape, k, s):
    assert tcp.calc_same_pad_conv2d(shape, k, s) \
        == jcp.calc_same_pad_conv2d(shape, k, s)


@pytest.mark.parametrize("mode", ["constant", "reflect", "replicate",
                                  "circular"])
@pytest.mark.parametrize("k,s", [(3, 1), (4, 2), (5, 3)])
def test_same_pad_conv2d(rng, mode, k, s):
    x = rng.normal(size=(2, 3, 9, 11)).astype(np.float32)
    ref = np.asarray(jcp.same_pad_conv2d(jnp.asarray(x), mode, k, s))
    got = tcp.same_pad_conv2d(torch.from_numpy(x), mode, k, s).numpy()
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    # a 3-d tensor pads its last two dims as well
    got3 = tcp.same_pad_conv2d(torch.from_numpy(x[0]), mode, k, s).numpy()
    np.testing.assert_array_equal(got3, ref[0])


def test_same_pad_conv2d_unknown_mode():
    with pytest.raises(KeyError):
        tcp.same_pad_conv2d(torch.zeros(1, 1, 4, 4), "wrap")


@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (4, 2), (5, 3)])
def test_same_unpad_deconv2d(rng, k, s):
    x = rng.normal(size=(2, 3, 13, 10)).astype(np.float32)
    ref = np.asarray(jcp.same_unpad_deconv2d(jnp.asarray(x), k, s))
    got = tcp.same_unpad_deconv2d(torch.from_numpy(x), k, s).numpy()
    np.testing.assert_array_equal(got, ref)


def test_get_norm_layer_kinds():
    assert tcp.get_norm_layer("none") is None
    assert isinstance(tcp.get_norm_layer("batch")(8), torch.nn.BatchNorm2d)
    inst = tcp.get_norm_layer("instance")(8)
    assert inst.num_groups == 8 and not inst.affine and inst.eps == 1e-6
    grp = tcp.get_norm_layer("group", group_norm_groups=4)(8)
    assert grp.num_groups == 4 and grp.affine and grp.eps == 1e-6
    with pytest.raises(NotImplementedError):
        tcp.get_norm_layer("layer")


@pytest.mark.parametrize("norm", ["batch", "instance", "group", "none"])
@pytest.mark.parametrize("act", ["leaky", "relu", None])
def test_make_conv_2d(rng, norm, act):
    """The padded input through JAX's and the port's block, with the JAX
    block's parameters (and BatchNorm statistics off their init) copied
    into the port's."""
    cin, cout, k, s = 3, 8, 3, 2
    x = rng.normal(size=(2, cin, 9, 10)).astype(np.float32)
    xp = np.asarray(jcp.same_pad_conv2d(jnp.asarray(x), "reflect", k, s))
    kw = dict(kernel_size=k, stride=s, use_bias=True,
              use_leaky_relu=act == "leaky")
    jblock = jcp.make_conv_2d(cin, cout, norm_layer=jcp.get_norm_layer(
        norm, group_norm_groups=4), activation=fnn.relu if act == "relu"
        else None, **kw)
    xh = jnp.asarray(xp.transpose(0, 2, 3, 1))
    v = jblock.init(jax.random.PRNGKey(0), xh)
    v = jax.tree_util.tree_map_with_path(
        lambda p, a: a + 0.1 * jax.random.normal(
            jax.random.PRNGKey(len(jax.tree_util.keystr(p))), a.shape), v)
    v = jax.tree.map(np.asarray, v)
    if norm == "batch":
        v["batch_stats"]["layers_1"]["var"] = np.abs(
            v["batch_stats"]["layers_1"]["var"]) + 0.5
    ref = np.asarray(jblock.apply(v, xh)).transpose(0, 3, 1, 2)

    tblock = tcp.make_conv_2d(cin, cout, norm_layer=tcp.get_norm_layer(
        norm, group_norm_groups=4), activation=torch.relu if act == "relu"
        else None, **kw).eval()
    p = v["params"]
    with torch.no_grad():
        tblock[0].weight.copy_(torch.from_numpy(
            p["layers_0"]["kernel"].transpose(3, 2, 0, 1)))
        tblock[0].bias.copy_(torch.from_numpy(p["layers_0"]["bias"]))
        if norm in ("batch", "group"):
            tblock[1].weight.copy_(torch.from_numpy(p["layers_1"]["scale"]))
            tblock[1].bias.copy_(torch.from_numpy(p["layers_1"]["bias"]))
        if norm == "batch":
            s_ = v["batch_stats"]["layers_1"]
            tblock[1].running_mean.copy_(torch.from_numpy(s_["mean"]))
            tblock[1].running_var.copy_(torch.from_numpy(s_["var"]))
    with torch.no_grad():
        got = tblock(torch.from_numpy(xp)).numpy()
    assert got.shape == ref.shape == (2, cout, 5, 5)
    np.testing.assert_allclose(got, ref, atol=FWD_TOL * max(
        1.0, np.abs(ref).max()))
