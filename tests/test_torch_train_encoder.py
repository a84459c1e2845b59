"""The port's train-mode encoders against the JAX package's on the CPU:
BatchNorm on the batch's statistics (biased variance, in f32), the
running statistics updated as momentum x old + (1 - momentum) x batch
(ResNet: 0.9, ELAN: 0.97), the latent and the gradient of a projection
of it with respect to every encoder parameter, with the same weights
(``convert.from_jax_variables``)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pixelnerf_yolo_tpu.models import make_model as jmake_model
from pixelnerf_yolo_torch.convert import from_jax_variables
from torch_parity import (perturbed_variables, port_model, small_flagship,
                          small_yolo, to_np, yolo_scene)

# f32 on both sides; the batch statistics are sums over the batch and the
# map in another order
FWD_TOL, STAT_TOL, GRAD_TOL = 2e-5, 1e-5, 1e-4


def _conf(kind):
    if kind == "elan":
        return small_yolo()
    return small_flagship()


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("kind", ["elan", "resnet18"])
def test_train_mode_encoder_matches_jax(kind, layout):
    """layout: the memory layout of the encoder's NCHW input, contiguous
    (as the trainer passes it) or channels-last."""
    conf = _conf(kind)
    jm = jmake_model(conf.get_config("model"))
    images = yolo_scene(ns=3)[0][0]
    v = perturbed_variables(jm, images, encoder_stats=True)
    x = np.transpose(images, (0, 2, 3, 1))
    if layout == "nhwc":
        x = np.ascontiguousarray(x)
    rng = np.random.default_rng(0)
    enc_vars = {"params": v["params"]["encoder"],
                "batch_stats": v["batch_stats"]["encoder"]}
    ref_out, mutated = jm.encoder.apply(enc_vars, jnp.asarray(x), train=True,
                                        mutable=["batch_stats"])
    proj = rng.normal(size=ref_out.shape).astype(np.float32)

    def f(params):
        out, _ = jm.encoder.apply(
            {"params": params, "batch_stats": enc_vars["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(out * proj)

    ref_g = jax.grad(f)(enc_vars["params"])

    tm = port_model(conf, v)
    out = tm.encoder(torch.from_numpy(x), train=True)
    (out * torch.from_numpy(proj)).sum().backward()
    np.testing.assert_allclose(to_np(out), np.asarray(ref_out), rtol=0,
                               atol=FWD_TOL * float(np.abs(ref_out).max()))

    def full(tree):  # encoder subtree -> the model's state_dict names
        params = jax.tree.map(np.zeros_like, v["params"])
        params["encoder"] = jax.tree.map(np.asarray, tree[0])
        stats = jax.tree.map(np.asarray, dict(v["batch_stats"]))
        stats["encoder"] = jax.tree.map(np.asarray, tree[1])
        return from_jax_variables({"params": params, "batch_stats": stats})

    ref_stats = full((enc_vars["params"], mutated["batch_stats"]))
    ref_grads = full((ref_g, enc_vars["batch_stats"]))
    old = from_jax_variables(v)
    state = tm.state_dict()
    n_stats = 0
    for name, t in state.items():
        if not name.startswith("encoder.") or "running" not in name:
            continue
        n_stats += 1
        np.testing.assert_allclose(t.numpy(), ref_stats[name].numpy(),
                                   rtol=0, atol=STAT_TOL, err_msg=name)
        assert not np.array_equal(t.numpy(), old[name].numpy()), name
    assert n_stats >= 10
    for name, p in tm.encoder.named_parameters():
        key = "encoder." + name
        r = ref_grads[key].numpy()
        scale = np.abs(r).max()
        assert scale > 0, key
        assert np.abs(p.grad.numpy() - r).max() <= GRAD_TOL * scale, key


@pytest.mark.parametrize("kind", ["elan", "resnet18"])
def test_eval_mode_leaves_running_stats(kind):
    tm = port_model(_conf(kind), perturbed_variables(
        jmake_model(_conf(kind).get_config("model")), yolo_scene(ns=1)[0][0],
        encoder_stats=True))
    before = {k: t.clone() for k, t in tm.state_dict().items()}
    x = torch.from_numpy(np.transpose(yolo_scene(ns=2)[0][0], (0, 2, 3, 1)))
    with torch.no_grad():
        tm.encoder(x)
    for k, t in tm.state_dict().items():
        assert torch.equal(t, before[k]), k


def test_batch_norm_variance_is_biased():
    """Train mode normalizes with the variance divided by N (not N - 1)
    and moves the running variance toward that biased value."""
    from pixelnerf_yolo_torch.nn.resnet import batch_norm

    m = torch.nn.BatchNorm2d(2, eps=1e-5)
    x = torch.randn((2, 2, 3, 3), generator=torch.Generator().manual_seed(0))
    y = batch_norm(x, m, torch.float32, train=True, momentum=0.9)
    var = x.var(dim=(0, 2, 3), unbiased=False)
    ref = (x - x.mean(dim=(0, 2, 3))[:, None, None]) \
        / torch.sqrt(var + 1e-5)[:, None, None]
    torch.testing.assert_close(y, ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(m.running_var, 0.9 + 0.1 * var, rtol=0,
                               atol=1e-6)
    torch.testing.assert_close(m.running_mean,
                               0.1 * x.mean(dim=(0, 2, 3)), rtol=0, atol=1e-6)


def test_pretrained_without_graft_warns():
    """``encoder.pretrained = True``: the JAX package grafts ImageNet
    weights over a ResNet and warns and keeps the random init when its npz
    is missing (it is, in this repo); the port, which has no graft yet,
    warns the same way and keeps the random init.  The ELAN backbone has
    no pretrained source: no warning."""
    import warnings

    from pixelnerf_yolo_torch.models import make_model

    conf = small_flagship().get_config("model")
    conf.put("encoder.pretrained", True)
    with pytest.warns(UserWarning, match="item 16"):
        a = make_model(conf, device="cpu")
    b = make_model(small_flagship().get_config("model"), device="cpu")
    for k, t in a.state_dict().items():
        assert torch.equal(t, b.state_dict()[k]), k
    yolo = small_yolo().get_config("model")
    yolo.put("encoder.pretrained", True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        make_model(yolo, device="cpu")
