"""bf16 tensor parallelism: how the ranks' partial products are summed.

XLA sums a bf16 product that is split over 'model' in f32 and rounds it
once (the compiled program of JAX's split block all-reduces the f32
products: ``test_jax_all_reduces_f32_partials``); the port's split
ResnetBlockFC does the same since its partial products became f32.  One
spawn of 4 CPU ranks over gloo runs (a) one bf16 block split 4 ways,
against JAX's block jitted with its fc_0 / fc_1 sharded over 4 virtual
devices and against the unsplit block, and (b) one bf16 YOLO update (its
colour jitter seeded) on {data 2, rays 1, model 2} (the kernel route,
whose backward recomputes the split blocks), against JAX's update on the
same mesh and each package's 1-device update, gradient by gradient.

Tolerances.  (a) The split block equals the unsplit port block and
JAX's split block up to the f32 summation order: its output and its
input gradient bitwise in at least 99% of the entries (Y_EQUAL), its
input and weight gradients within 4 bf16 ulps of the largest entry
(DX_ULPS); a block that rounds each rank's partial to bf16 before the sum
fails the share.  (b) Every gradient's relative L2 distance: port TP to
port 1-rank within 5e-2 (GRAD_TP, phase 8's bf16 limit), the field MLP's
within 1e-2 (GRAD_TP_FIELD); JAX's TP to JAX's 1-device within GRAD_TP;
port TP to JAX TP within the two packages' own 1-device distance (bf16 rounding points that differ between them,
``tests/test_torch_train_yolo.py``) plus the same bound.  Losses: TP to
1-rank within 1e-3 relative (LOSS_TP), to JAX's TP within 1e-2
(LOSS_PACKAGES); post-Adam parameters within JAX's _tree_allclose
bound."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from parallel_train_cases import (case_spec, check_close, jax_trainer,
                                  jax_update, port_trainer, state_np)
from pixelnerf_yolo_torch.convert import from_jax_variables
from synth_data import make_yolo_dataset
from torch_dist import run_ranks
from torch_parity import one_torch_thread  # noqa: F401

import torch_parallel_workers as workers

CHUNK = 15
PUTS = {"yolo.ray_batch_size": CHUNK, "model.compute_dtype": "bfloat16"}
EXTRA = {"nviews": "3"}
H, ROWS = 64, 256
ULP = 2.0 ** -8  # bf16: 8 bits of mantissa with the implicit one
Y_EQUAL = 0.99  # share of the split block's outputs bitwise the whole's
DX_ULPS = 4  # gradients: bf16 ulps of the largest entry
# TP vs 1-device gradients, relative L2: every one within phase 8's bf16
# limit (the encoder's BatchNorm gradients cancel, which amplifies any
# change of summation order), the port's field MLP's within 1e-2 (JAX's
# own TP moves its field gradients by up to 2e-2 on some jitter draws:
# it is held to GRAD_TP)
GRAD_TP, GRAD_TP_FIELD = 5e-2, 1e-2
LOSS_TP, LOSS_PACKAGES = 1e-3, 1e-2  # losses, relative


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def ulps(got, ref):
    """Largest |got - ref| in bf16 ulps of |ref| (of the smallest normal
    step at 0)."""
    ref = np.asarray(ref, np.float64)
    step = np.maximum(np.abs(ref), 2.0 ** -10) * ULP
    return float(np.max(np.abs(np.asarray(got, np.float64) - ref) / step))


def block_weights(seed=0):
    rng = np.random.default_rng(seed)
    w = {"fc_0.weight": rng.normal(0, 0.2, (H, H)),
         "fc_0.bias": rng.normal(0, 0.1, H),
         "fc_1.weight": rng.normal(0, 0.2, (H, H)),
         "fc_1.bias": rng.normal(0, 0.1, H)}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    x = rng.normal(0, 1, (ROWS, H)).astype(np.float32)
    gy = rng.normal(0, 1, (ROWS, H)).astype(np.float32)
    return w, x, gy


def jax_block(w, x, gy, n_model, hlo=False):
    """JAX's bf16 ResnetBlockFC, its fc_0 / fc_1 split over n_model
    virtual devices as ``tp_shardings`` splits them: (y, dx, grads in the
    port's layout), or with hlo the compiled program's text."""
    from pixelnerf_yolo_tpu.nn.resnetfc import ResnetBlockFC
    from pixelnerf_yolo_tpu.parallel import tp_shardings

    blk = ResnetBlockFC(dtype="bfloat16")
    params = {"fc_0": {"kernel": jnp.asarray(w["fc_0.weight"].T),
                       "bias": jnp.asarray(w["fc_0.bias"])},
              "fc_1": {"kernel": jnp.asarray(w["fc_1.weight"].T),
                       "bias": jnp.asarray(w["fc_1.bias"])}}
    mesh = Mesh(np.asarray(jax.devices()[:n_model]), ("model",))
    params = jax.device_put(params, tp_shardings(params, mesh))
    xb = jnp.asarray(x, jnp.bfloat16)

    def f(p, xb):
        y, vjp = jax.vjp(lambda p, xb: blk.apply({"params": p}, xb), p, xb)
        return (y,) + vjp(jnp.asarray(gy, jnp.bfloat16))

    fn = jax.jit(f, out_shardings=NamedSharding(mesh, P()))
    if hlo:
        return fn.lower(params, xb).compile().as_text()
    y, gp, gx = fn(params, xb)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    grads = {"fc_0.weight": f32(gp["fc_0"]["kernel"]).T,
             "fc_0.bias": f32(gp["fc_0"]["bias"]),
             "fc_1.weight": f32(gp["fc_1"]["kernel"]).T,
             "fc_1.bias": f32(gp["fc_1"]["bias"])}
    return f32(y), f32(gx), grads


def test_jax_all_reduces_f32_partials():
    """The finding the port follows: XLA's program for JAX's split bf16
    block all-reduces f32 partial products (fc_1's forward, fc_0's input
    gradient), never bf16 ones."""
    lines = jax_block(*block_weights(), 4, hlo=True).splitlines()
    reduces = [line.split("=", 1)[1].split("all-reduce(")[0]
               for line in lines if " all-reduce(" in line]
    assert reduces and all("f32[" in t and "bf16" not in t
                           for t in reduces)
    # what they sum: fc_1's product (forward) and fc_0's input gradient
    summed = " ".join(line for line in lines
                      if "get-tuple-element(%all-reduce" in line
                      or " all-reduce(" in line)
    assert "fc_1/dot_general" in summed
    assert "transpose(jvp(ResnetBlockFC))/resblock" in summed
    assert "fc_0/dot_general" in summed


def port_block(w, x, gy):
    from pixelnerf_yolo_torch.nn.resnetfc import ResnetBlockFC

    blk = ResnetBlockFC(H, dtype=torch.bfloat16)
    blk.load_state_dict({k: torch.as_tensor(v) for k, v in w.items()})
    xt = torch.as_tensor(x).to(torch.bfloat16).requires_grad_(True)
    y = blk(xt)
    (y.float() * torch.as_tensor(gy)).sum().backward()
    return (y.float().detach().numpy(), xt.grad.float().numpy(),
            {k: p.grad.numpy() for k, p in blk.named_parameters()})


def jax_grads(jtr, assembled, mesh=None):
    """The gradients of JAX's 1-device YOLO loss (torch_parity's
    assembly) on the trainer's ``_assemble``d batch at its weights, jitted
    with the parameters placed by ``tp_shardings`` on mesh when given: in
    the port's layout."""
    from pixelnerf_yolo_tpu.parallel import tp_shardings

    jm, jr, yl = jtr.model, jtr.renderer, jtr.yolo_loss
    A = jtr.num_anchors_per_scale
    (si, sp, focal, c, rays, tg, anc, n_real, _) = assembled
    _, sub = jax.random.split(jax.random.PRNGKey(2))  # seed + 2
    SB, k, R = rays.shape[:3]
    inputs = [jnp.asarray(a) for a in (si, sp, focal, c, rays, tg, anc)]
    variables = jtr.variables

    def loss_fn(params):
        vs = {"params": params, "batch_stats": variables["batch_stats"]}
        cond = jm.encode(vs, *inputs[:3], c=inputs[3], train=True)[0]
        r = jr(jm, vs, cond, inputs[4].reshape(SB, k * R, 8), sub)
        losses = jax.vmap(lambda a, b, an: jnp.stack(yl(a, b, an)))(
            r.reshape(SB * k, R, A, 7), inputs[5].reshape(SB * k, R, A, 6),
            jnp.broadcast_to(inputs[6][None], (SB, k, A, 2))
            .reshape(SB * k, A, 2))
        return jnp.sum(losses[:, 0])

    params = variables["params"]
    if mesh is not None:
        params = jax.device_put(params, tp_shardings(params, mesh))
    grads = jax.jit(jax.grad(loss_fn))(params)
    grads = jax.tree.map(lambda g: np.asarray(g, np.float32), grads)
    state = from_jax_variables({"params": grads,
                                "batch_stats": variables["batch_stats"]})
    return {k: t.numpy() for k, t in state.items() if "running" not in k
            and "num_batches" not in k}


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    from pixelnerf_yolo_torch.data import DataLoader, get_split_dataset
    from pixelnerf_yolo_tpu import parallel as jpar
    from parallel_train_cases import port_conf
    from torch_parity import jax_yolo_trainer

    tmp = tmp_path_factory.mktemp("bf16_tp")
    root = make_yolo_dataset(str(tmp / "data"), n_scenes=2, n_views=4,
                             img_size=64)
    dset = get_split_dataset("yolo", root,
                             conf=port_conf("yolo", "true", PUTS))[0]
    dset._rng = np.random.default_rng(0)  # the colour jitter: one batch
    batch = next(iter(DataLoader(dset, batch_size=2)))
    # JAX's update on {data 2, rays 1, model 2}: no ray padding there, so
    # every leg below takes the same draws
    jtr, v = jax_trainer("yolo", root, tmp / "jax_tp", 2, 2, "true", None,
                         EXTRA, PUTS)
    j_losses, j_vars, u, _ = jax_update("yolo", jtr, batch)
    j1, _ = jax_yolo_trainer(root, tmp / "jax_1", "true", "bfloat16",
                             puts={"yolo.ray_batch_size": CHUNK})
    j1.variables = jax.tree.map(jnp.asarray, v)
    mesh = jpar.make_train_mesh(n_devices=4, batch_size=2, model_parallel=2)
    assembled = j1._assemble(batch)  # its view choice advances _rng
    refs = {"jax_tp": jax_grads(j1, assembled, mesh),
            "jax_1": jax_grads(j1, assembled),
            "jax_losses": j_losses,
            "jax_state": from_jax_variables(j_vars)}
    one = port_trainer("yolo", root, tmp / "one", v, "true", None, EXTRA,
                       PUTS)
    refs["one_losses"] = {k: float(x) for k, x in one.train_step(
        batch, u=torch.from_numpy(u)).items()}
    refs["one"] = {k: p.grad.float().numpy()
                   for k, p in one.model.named_parameters()
                   if p.grad is not None}

    w, x, gy = block_weights()
    refs["block_jax_tp"] = jax_block(w, x, gy, 4)
    refs["block_jax_1"] = jax_block(w, x, gy, 1)
    refs["block_port_1"] = port_block(w, x, gy)
    spec = {"block": w, "x": x, "gy": gy, "tmp": str(tmp / "ranks"),
            "case": case_spec("yolo", "tp", root, v, "true", batch, u, 2, 2,
                              None, EXTRA, PUTS)}
    out = run_ranks(4, workers.bf16_tp_leg, spec, timeout=240)
    return refs, out


def max_rel(got, ref):
    return max(abs(got[k] - ref[k]) / abs(ref[k]) for k in ref)


def test_split_block_sums_partials_in_f32(legs):
    refs, out = legs
    got = out["block"]
    y1, dx1, g1 = refs["block_port_1"]
    yj, dxj, gj = refs["block_jax_tp"]
    for ref in (y1, yj):
        assert np.mean(got["y"] == ref) >= Y_EQUAL
    # JAX's split block is its unsplit block
    assert np.array_equal(yj, refs["block_jax_1"][0])
    for ref in (dx1, dxj):
        assert np.mean(got["x_grad"] == ref) >= Y_EQUAL
        np.testing.assert_allclose(got["x_grad"], ref, rtol=0,
                                   atol=DX_ULPS * ULP * np.abs(ref).max())
    for k in g1:
        for ref in (g1[k], gj[k]):
            np.testing.assert_allclose(got["grads"][k], ref, rtol=0,
                                       atol=DX_ULPS * ULP * np.abs(ref).max(),
                                       err_msg=k)


def test_tp_update_gradients(legs):
    refs, out = legs
    got, one, jtp, j1 = out["grads"], refs["one"], refs["jax_tp"], \
        refs["jax_1"]
    assert set(got) == set(one) == set(jtp) == set(j1)
    for keys, limit in ((list(one), GRAD_TP),
                        ([k for k in one if k.startswith("mlp_")],
                         GRAD_TP_FIELD)):
        worst = {name: max(rel_l2(a[k], b[k]) for k in keys)
                 for name, a, b in (("port tp / port 1", got, one),
                                    ("jax tp / jax 1", jtp, j1),
                                    ("port tp / jax tp", got, jtp),
                                    ("port 1 / jax 1", one, j1))}
        print("WORST", limit, worst)
        assert worst["port tp / port 1"] <= limit
        assert worst["jax tp / jax 1"] <= GRAD_TP
        assert worst["port tp / jax tp"] <= worst["port 1 / jax 1"] + limit


def test_tp_update_losses_and_parameters(legs):
    refs, out = legs
    print(max_rel(out["losses"], refs["one_losses"]),
          max_rel(out["losses"], refs["jax_losses"]))
    assert max_rel(out["losses"], refs["one_losses"]) <= LOSS_TP
    assert max_rel(out["losses"], refs["jax_losses"]) <= LOSS_PACKAGES
    check_close("bf16 tp", out["losses"], out["losses"], out["state"],
                state_np(refs["jax_state"]))
