"""Sharded YOLO training updates of the port on 4 CPU ranks over gloo
against the JAX package's update on the same mesh shape of 4 virtual
devices and against the port's 1-rank update, with the same weights,
batch, view choice and the JAX update's coarse draws over the padded
global batch: rays (SB, k, chunk, 8) as P(data, None, rays) ({data 2,
rays 2}, SB=2), the ragged variant (SB=3 on that mesh: P(None, None,
data x rays)), and the field split over 'model' ({data 2, rays 1, model
2}, the kernel route).  Each chunk pads to the mesh's ray multiple with
ignore-flag rows (15-ray chunks to 16).  Losses within rtol 2e-5,
post-Adam parameters within JAX's _tree_allclose bound (rtol 1e-3, atol
2.5e-4)."""

import pytest
import torch

from parallel_train_cases import (check_close, case_spec, jax_trainer,
                                  jax_update, port_trainer, state_np)
from pixelnerf_yolo_torch.convert import from_jax_variables
from synth_data import make_yolo_dataset
from torch_dist import run_ranks

import torch_parallel_workers as workers

CHUNK = 15  # yolo.ray_batch_size: pads to 16 on 2 and on 4 ray shards
PUTS = {"yolo.ray_batch_size": CHUNK}
EXTRA = {"nviews": "3"}
# (name, SB, mesh batch size, model_parallel, use_fused_mlp)
CASES = [("mesh", 2, 2, 1, "false"), ("ragged", 3, 2, 1, "false"),
         ("tp", 2, 2, 2, "true")]
MESHES = {"mesh": {"data": 2, "rays": 2}, "ragged": {"data": 2, "rays": 2},
          "tp": {"data": 2, "rays": 1, "model": 2}}


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    from pixelnerf_yolo_torch.data import DataLoader, get_split_dataset

    tmp = tmp_path_factory.mktemp("par_yolo")
    root = make_yolo_dataset(str(tmp / "data"), n_scenes=3, n_views=4,
                             img_size=64)
    conf = __import__("parallel_train_cases").port_conf("yolo", "false",
                                                       PUTS)
    dset = get_split_dataset("yolo", root, conf=conf)[0]
    refs, cases = {}, []
    for name, sb, mesh_batch, mp, fused in CASES:
        batch = next(iter(DataLoader(dset, batch_size=sb)))
        jtr, v = jax_trainer("yolo", root, tmp / name, mesh_batch, mp,
                             fused, None, EXTRA, PUTS)
        losses, new_vars, u, ss = jax_update("yolo", jtr, batch)
        assert ss == (name != "ragged")
        one = port_trainer("yolo", root, tmp / (name + "_1"), v, fused, None,
                           EXTRA, PUTS)
        # one chunk a scene here (3 views of 2 x 2 cells); one rank pads
        # none of its rays
        K, Rp = u.shape[-1], u.shape[0] // sb
        cut = u.reshape(sb, Rp, K)[:, :CHUNK].reshape(-1, K)
        one_losses = {k: float(x) for k, x in one.train_step(
            batch, u=torch.from_numpy(cut)).items()}
        refs[name] = {"jax": (losses, from_jax_variables(new_vars)),
                      "one": (one_losses, one.model.state_dict())}
        cases.append(case_spec("yolo", name, root, v, fused, batch, u,
                               mesh_batch, mp, None, EXTRA, PUTS))
    out = run_ranks(4, workers.train_leg, {"cases": cases,
                                           "tmp": str(tmp / "ranks")},
                    timeout=240)
    return refs, out


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_update_matches_jax(legs, name):
    refs, out = legs
    got = out[name]
    assert got["mesh"] == MESHES[name]
    losses, state = refs[name]["jax"]
    check_close(name, got["losses"], losses, got["state"], state_np(state))


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_update_matches_one_rank(legs, name):
    refs, out = legs
    losses, state = refs[name]["one"]
    check_close(name, out[name]["losses"], losses, out[name]["state"],
                state_np(state))


def test_tp_ranks_hold_their_shards_and_moments(legs):
    _, out = legs
    H = 64
    for shards in out["tp"]["shards"]:
        assert shards
        for name, (p, m, v) in shards.items():
            want = {"fc_0.weight": (H // 2, H), "fc_0.bias": (H // 2,),
                    "fc_1.weight": (H, H // 2), "fc_1.bias": (H,)}[
                        name.split("blocks.0.")[1]]
            assert p == m == v == want, name
