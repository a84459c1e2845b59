"""Sharded NeRF training updates of the port on 4 CPU ranks over gloo
against the JAX package's update on the same mesh shape of 4 virtual
devices and against the port's 1-rank update, with the same weights, batch,
view and pixel choice, and the JAX update's draws over the padded global
batch: scenes on 'data' and rays on 'rays' ({data 2, rays 2}, SB=2), the
ragged variant (SB=3 on that mesh: scenes replicated, rays over data x
rays), and the field split over 'model' ({data 2, rays 1, model 2}, the
kernel route), whose ranks hold only their fc_0 / fc_1 shards and Adam
moments and whose checkpoint loads strictly into a 1-rank model and
renders its numbers.  Losses within rtol 2e-5, post-Adam parameters
within JAX's _tree_allclose bound (rtol 1e-3, atol 2.5e-4)."""

import numpy as np
import pytest
import torch

from parallel_train_cases import (check_close, case_spec, jax_trainer,
                                  jax_update, port_trainer, state_np)
from pixelnerf_yolo_torch.convert import from_jax_variables
from synth_data import make_srn_dataset
from torch_dist import run_ranks
from torch_parity import scene

import torch_parallel_workers as workers

SIZE = 32
RAYS = 23  # pads to 24 on 2 and on 4 ray shards
EXTRA = {"nviews": "2", "ray_batch_size": RAYS}
# (name, SB, mesh batch size, model_parallel, use_fused_mlp)
CASES = [("mesh", 2, 2, 1, "false"), ("ragged", 3, 2, 1, "false"),
         ("tp", 2, 2, 2, "true")]
MESHES = {"mesh": {"data": 2, "rays": 2}, "ragged": {"data": 2, "rays": 2},
          "tp": {"data": 2, "rays": 1, "model": 2}}


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    from pixelnerf_yolo_torch.data import DataLoader, get_split_dataset

    tmp = tmp_path_factory.mktemp("par_nerf")
    root = str(tmp / "data" / "cars")
    for stage in ("train", "val", "test"):
        make_srn_dataset(root, stage=stage, n_objs=3, n_views=5,
                         img_size=SIZE)
    dset = get_split_dataset("srn", root, image_size=(SIZE, SIZE))[0]
    refs, cases = {}, []
    for name, sb, mesh_batch, mp, fused in CASES:
        batch = next(iter(DataLoader(dset, batch_size=sb)))
        jtr, v = jax_trainer("nerf", root, tmp / name, mesh_batch, mp,
                             fused, SIZE, EXTRA)
        losses, new_vars, draws, ss = jax_update("nerf", jtr, batch)
        assert ss == (name != "ragged")
        one = port_trainer("nerf", root, tmp / (name + "_1"), v, fused, SIZE,
                           EXTRA)
        Rp = draws["u_coarse"].shape[0] // sb
        cut = {k: torch.from_numpy(d.reshape(sb, Rp, -1)[:, :RAYS]
                                   .reshape(-1, d.shape[-1]))
               for k, d in draws.items()}
        one_losses = {k: float(x) for k, x in
                      one.train_step(batch, draws=cut).items()}
        spec = case_spec("nerf", name, root, v, fused, batch, draws,
                         mesh_batch, mp, SIZE, EXTRA)
        refs[name] = {"jax": (losses, from_jax_variables(new_vars)),
                      "one": (one_losses, one.model.state_dict()), "v": v}
        if name == "tp":
            images, poses, focal = scene(ns=2)
            rays = np.random.default_rng(0).normal(size=(1, 10, 8)) \
                .astype(np.float32) * 0.1
            rays[..., 2] -= 1.3
            rays[..., 3:6] = [0.0, 0.0, 1.0]
            rays[..., 6], rays[..., 7] = 0.8, 1.8
            r = one.renderer
            spec.update(save=True, scene=(images, poses, focal), rays=rays,
                        render_draws={k: v.numpy() for k, v in r.draw(
                            10, torch.Generator().manual_seed(5)).items()})
        cases.append(spec)
    out = run_ranks(4, workers.train_leg, {"cases": cases,
                                           "tmp": str(tmp / "ranks")},
                    timeout=240)
    return refs, {c["name"]: c for c in cases}, out


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_update_matches_jax(legs, name):
    refs, _, out = legs
    got = out[name]
    assert got["mesh"] == MESHES[name]
    losses, state = refs[name]["jax"]
    check_close(name, got["losses"], losses, got["state"], state_np(state))


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_update_matches_one_rank(legs, name):
    refs, _, out = legs
    losses, state = refs[name]["one"]
    check_close(name, out[name]["losses"], losses, out[name]["state"],
                state_np(state))


def test_tp_ranks_hold_their_shards_and_moments(legs):
    """Each rank's fc_0 / fc_1 parameters and both Adam moments are the
    rank's H/2 slice; the replicated parameters' whole."""
    _, _, out = legs
    H = 64
    for shards in out["tp"]["shards"]:
        assert shards, "no block parameter on a rank"
        for name, (p, m, v) in shards.items():
            want = {"fc_0.weight": (H // 2, H), "fc_0.bias": (H // 2,),
                    "fc_1.weight": (H, H // 2), "fc_1.bias": (H,)}[
                        name.split("blocks.0.")[1]]
            assert p == m == v == want, name


def test_tp_checkpoint_loads_into_one_rank(legs):
    """The checkpoint rank 0 wrote holds the single-device layout: it
    loads strictly into a fresh 1-rank model, equals the gathered update,
    and renders the ranks' tensor-parallel render."""
    from pixelnerf_yolo_torch.models import make_model
    from pixelnerf_yolo_torch.render import make_renderer
    from pixelnerf_yolo_torch.train import checkpoints

    _, cases, out = legs
    case, got = cases["tp"], out["tp"]
    conf = __import__("parallel_train_cases").port_conf("nerf", "true")
    model = make_model(conf.get_config("model"), device="cpu",
                       load_pretrained=False)
    state = checkpoints.load_state(got["ckpt"])
    model.load_state_dict(state, strict=True)
    for k, t in state.items():
        np.testing.assert_array_equal(t.float().numpy(), got["state"][k],
                                      err_msg=k)
    with torch.no_grad():
        cond = model.encode(*case["scene"])
        one = make_renderer(conf, device="cpu")(
            model, cond, case["rays"],
            draws={k: torch.from_numpy(v)
                   for k, v in case["render_draws"].items()})
    for p in ("coarse", "fine"):
        for k in ("rgb", "depth"):
            np.testing.assert_allclose(got["render"][p][k],
                                       one[p][k].numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=p + k)
