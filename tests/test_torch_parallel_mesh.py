"""The port's meshes, tensor-parallel plan and collectives
(pixelnerf_yolo_torch/parallel) against the JAX package's
pixelnerf_yolo_tpu/parallel on its virtual 8-device CPU mesh: the axis
sizes of make_train_mesh, the parameters tp_shardings shards over 'model'
(leaf for leaf, through the checkpoint converter), the refusals and the
edge padding; then, on 4 CPU ranks over gloo, the DeviceMesh the port
builds and the gradients through Megatron's f / g pair, exact against one
process's float64 evaluation."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pixelnerf_yolo_torch import parallel as tpar
from pixelnerf_yolo_tpu import parallel as jpar
from torch_dist import run_ranks
from torch_parity import small_flagship, small_yolo

import torch_parallel_workers as workers

SHAPES = [(1, 1), (2, 1), (3, 1), (2, 2), (1, 2)]


def _jax_shape(n, bs, mp):
    try:
        return dict(jpar.make_train_mesh(n_devices=n, batch_size=bs,
                                         model_parallel=mp).shape)
    except ValueError as e:
        return str(e)


def _port_shape(n, bs, mp):
    try:
        return tpar.train_mesh_shape(n, bs, mp)
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("mp", [1, 2])
@pytest.mark.parametrize("bs", [1, 2, 3])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_train_mesh_shape_matches_jax(n, bs, mp):
    """The ('data', 'rays'[, 'model']) sizes in JAX's axis order, or the
    same refusal (model_parallel must divide the device count)."""
    ref, got = _jax_shape(n, bs, mp), _port_shape(n, bs, mp)
    assert got == ref
    if isinstance(ref, dict):
        assert list(got) == list(ref)


def _jax_variables(conf):
    from pixelnerf_yolo_tpu.models import make_model

    jm = make_model(conf.get_config("model"))
    ns = 3 if jm.yolo else 2
    return jm.init(jax.random.PRNGKey(0),
                   jnp.zeros((ns, 3, 32, 32), jnp.float32))


@pytest.mark.parametrize("kind", ["nerf", "yolo"])
def test_tp_plan_matches_tp_shardings(kind):
    """Each parameter's sharded dimension: JAX's spec carried through the
    converter (an array that counts along the sharded axis, -1 where
    replicated) against ``tp_plan`` in the torch layout."""
    from pixelnerf_yolo_torch.convert import from_jax_variables

    conf = small_flagship() if kind == "nerf" else small_yolo()
    v = _jax_variables(conf)
    mesh = jpar.make_train_mesh(n_devices=4, batch_size=1, model_parallel=2)
    specs = jpar.tp_shardings(v, mesh)

    def marker(leaf, sh):
        spec = tuple(sh.spec) + (None,) * (leaf.ndim - len(sh.spec))
        if "model" not in spec:
            return np.full(leaf.shape, -1.0, np.float32)
        ax = spec.index("model")
        idx = np.arange(leaf.shape[ax], dtype=np.float32)
        shape = [1] * leaf.ndim
        shape[ax] = -1
        return np.broadcast_to(idx.reshape(shape), leaf.shape).copy()

    marked = from_jax_variables(jax.tree.map(marker, v, specs))
    plan = tpar.tp_plan(((k, t.shape) for k, t in marked.items()), 2)
    assert set(plan) == set(marked)
    n_sharded = 0
    for name, t in marked.items():
        t = t.numpy()
        # num_batches_tracked is the port's own (0, never sharded)
        if (t == -1).all() or name.endswith("num_batches_tracked"):
            assert plan[name] is None, name
            continue
        varies = [d for d in range(t.ndim) if t.shape[d] > 1
                  and not (np.diff(t, axis=d) == 0).all()]
        assert plan[name] is not None and varies == [plan[name]], name
        n_sharded += 1
    # fc_0 weight and bias, fc_1 weight of every block of every MLP
    blocks = sum(1 for k in marked if k.endswith("fc_0.weight"))
    assert blocks >= 5 and n_sharded == 3 * blocks


def test_tp_refusals_match_jax():
    """An indivisible d_hidden and an indivisible model_parallel are
    refused with JAX's messages."""
    conf = small_flagship()
    v = _jax_variables(conf)
    mesh = jpar.make_train_mesh(n_devices=3, batch_size=1, model_parallel=3)
    with pytest.raises(ValueError) as ref:
        jpar.tp_shardings(v, mesh)
    from pixelnerf_yolo_torch.models import make_model

    model = make_model(conf.get_config("model"), device="cpu",
                       load_pretrained=False)
    with pytest.raises(ValueError) as got:
        tpar.tp_plan(((k, t.shape) for k, t in model.state_dict().items()),
                     3)
    head = "d_hidden 64 not divisible by model_parallel 3"
    assert str(ref.value).startswith(head)
    assert str(got.value).startswith(head)
    with pytest.raises(ValueError, match="must divide the device count 3"):
        jpar.make_train_mesh(n_devices=3, model_parallel=2)
    with pytest.raises(ValueError, match="must divide the device count 3"):
        tpar.train_mesh_shape(3, 1, 2)


@pytest.mark.parametrize("shape,axis,multiple", [((5, 3), 0, 4),
                                                 ((1, 7, 8), 1, 4),
                                                 ((2, 8, 8), 1, 4)])
def test_pad_to_multiple_matches_jax(shape, axis, multiple):
    import torch

    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    ref, n_ref = jpar._pad_to_multiple(jnp.asarray(x), axis, multiple)
    got, n = tpar._pad_to_multiple(torch.from_numpy(x), axis, multiple)
    assert n == n_ref
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.fixture(scope="module")
def ranks():
    """One 4-rank run: the DeviceMeshes and the collectives."""
    rng = np.random.default_rng(0)
    spec = {"shapes": SHAPES,
            "x": rng.normal(size=(4, 6)),
            "w0": rng.normal(size=(8, 6)),
            "w1": rng.normal(size=(6, 8)),
            "gy": rng.normal(size=(4, 6))}
    return spec, run_ranks(4, workers.mesh_leg, spec)


def test_device_mesh_matches_train_mesh_shape(ranks):
    _, out = ranks
    for bs, mp in SHAPES:
        want = tpar.train_mesh_shape(4, bs, mp)
        assert out["shapes"][(bs, mp)] == want
        assert out["shapes"][(bs, mp)] == dict(
            jpar.make_train_mesh(n_devices=4, batch_size=bs,
                                 model_parallel=mp).shape)
        # rank r = ray shard r // mp, model index r % mp; the
        # ray-sharding group spans every axis but 'model'
        n_ray = 4 // mp
        assert out["coords"][(bs, mp)] == [(r // mp, r % mp, n_ray)
                                           for r in range(4)]


def test_tp_pair_gradients_exact(ranks):
    """f / g around a column- then row-parallel pair on 4 ranks (float64):
    the output and every gradient as one process computes them."""
    import torch

    spec, out = ranks
    x = torch.tensor(spec["x"], requires_grad=True)
    w0 = torch.tensor(spec["w0"], requires_grad=True)
    w1 = torch.tensor(spec["w1"], requires_grad=True)
    y = torch.relu(x @ w0.t()) @ w1.t()
    (y * torch.tensor(spec["gy"])).sum().backward()
    tp = out["tp"]
    np.testing.assert_allclose(tp["y"], y.detach().numpy(), rtol=1e-12)
    np.testing.assert_allclose(tp["x_grad"], x.grad.numpy(), rtol=1e-12)
    np.testing.assert_allclose(np.concatenate(tp["w0_grad"], 0),
                               w0.grad.numpy(), rtol=1e-12)
    np.testing.assert_allclose(np.concatenate(tp["w1_grad"], 1),
                               w1.grad.numpy(), rtol=1e-12)


def test_gather_backward(ranks):
    """gather_along: the ranks' rows in rank order, each rank's gradient
    its own slice; gather_stats: each rank's gradient the sum over the
    ranks of their cotangents (1 + 2 + 3 + 4 = 10)."""
    spec, out = ranks
    g = out["gather"]
    np.testing.assert_array_equal(g["whole"], spec["x"])
    for r in range(4):
        np.testing.assert_array_equal(g["along_grads"][r], spec["x"][r:r + 1])
        np.testing.assert_array_equal(g["stats_grads"][r],
                                      np.full(spec["x"].shape[1], 10.0))


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("size_out", [32, 16])
def test_unbound_block_is_the_single_device_block(cdt, int8, size_out):
    """With no 'model' group a ResnetBlockFC's f / g form (f and g the
    identity, fc_1's bias added after the partial product) is the
    single-device block, dense(act(dense(act(x), fc_0)), fc_1) plus the
    shortcut: forward and every gradient bitwise."""
    import torch

    from pixelnerf_yolo_torch.nn.resnetfc import (ResnetBlockFC,
                                                  activation, dense)

    dt = getattr(torch, cdt)
    blk = ResnetBlockFC(32, size_out, beta=0.0, dtype=dt,
                        generator=torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for t in (blk.fc_0.bias, blk.fc_1.weight, blk.fc_1.bias):
            t.normal_(generator=g)
    x = torch.randn(64, 32, generator=g).to(dt).requires_grad_()
    params = list(blk.parameters())
    y = blk(x, int8)
    dy = torch.randn(y.shape, generator=g).to(y.dtype)
    got = torch.autograd.grad(y, [x] + params, dy)

    x2 = x.detach().clone().requires_grad_()
    act = activation(0.0)
    dx = dense(act(dense(act(x2), blk.fc_0, dt, int8)), blk.fc_1, dt, int8)
    xs = x2 if blk.shortcut is None else dense(x2, blk.shortcut, dt, int8)
    y2 = xs + dx
    want = torch.autograd.grad(y2, [x2] + params, dy)
    assert torch.equal(y, y2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
