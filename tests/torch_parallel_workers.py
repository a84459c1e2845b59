"""What the ranks of the multi-rank tests run (tests/torch_dist.py): the
port only, no JAX.  Each function is fn(rank, n, spec) and returns numpy
results from rank 0; spec carries the weights (a state_dict of numpy
arrays), the conf (a dict), the inputs and the draws, all made in the
test process."""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from pixelnerf_yolo_torch import parallel
from pixelnerf_yolo_torch.parallel import collectives
from pixelnerf_yolo_torch.parallel.render import RenderParallel


def to_np(tree):
    if isinstance(tree, dict):
        return {k: to_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_np(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().cpu().numpy()
    return tree


def gather_objects(obj) -> list:
    """Every rank's obj, in rank order."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def build_model(conf_dict, state):
    from pixelnerf_yolo_torch.config.hocon import Config
    from pixelnerf_yolo_torch.models import make_model

    conf = Config(conf_dict)
    model = make_model(conf.get_config("model"), device="cpu",
                       load_pretrained=False)
    model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                           for k, v in state.items()}, strict=True)
    return conf, model


def renderer_of(conf):
    from pixelnerf_yolo_torch.render import make_renderer

    return make_renderer(conf, device="cpu")


# -- meshes and collectives ------------------------------------------------------


def mesh_leg(rank, n, spec):
    """The DeviceMesh shapes of make_train_mesh, the ray-sharding groups,
    and the f / g pair's gradients (float64) against one process's."""
    out = {"shapes": {}}
    for bs, mp in spec["shapes"]:
        mesh = parallel.make_train_mesh(batch_size=bs, model_parallel=mp)
        out["shapes"][(bs, mp)] = dict(zip(mesh.mesh_dim_names, mesh.shape))
        out.setdefault("coords", {})[(bs, mp)] = gather_objects(
            (parallel.shard_index(mesh),
             parallel.axis_index(mesh, parallel.MODEL_AXIS),
             collectives.group_size(parallel.mesh_group(
                 mesh, parallel.ray_axes(mesh)))))
    # column-parallel fc_0 then row-parallel fc_1 over every rank
    g = dist.group.WORLD
    x = torch.as_tensor(spec["x"]).requires_grad_(True)
    H = spec["w0"].shape[0] // n
    w0 = torch.as_tensor(spec["w0"][rank * H:(rank + 1) * H]).requires_grad_()
    w1 = torch.as_tensor(spec["w1"][:, rank * H:(rank + 1) * H])
    w1.requires_grad_(True)
    h = torch.relu(collectives.copy_to_group(x, g) @ w0.t())
    y = collectives.reduce_from_group(h @ w1.t(), g)
    (y * torch.as_tensor(spec["gy"])).sum().backward()
    out["tp"] = {"y": y.detach().numpy(), "x_grad": x.grad.numpy(),
                 "w0_grad": gather_objects(w0.grad.numpy()),
                 "w1_grad": gather_objects(w1.grad.numpy())}
    # gather_along: the backward keeps the rank's slice; gather_stats: the
    # gradient summed over the ranks first
    piece = torch.as_tensor(spec["x"][rank:rank + 1]).requires_grad_(True)
    whole = collectives.gather_along(piece, 0, g)
    (whole * torch.as_tensor(spec["x"])).sum().backward()
    stats = torch.as_tensor(spec["x"][rank]).requires_grad_(True)
    gathered = collectives.gather_stats(stats, g)
    (gathered * float(rank + 1)).sum().backward()
    out["gather"] = {"whole": whole.detach().numpy(),
                     "along_grads": gather_objects(piece.grad.numpy()),
                     "stats_grads": gather_objects(stats.grad.numpy())}
    return out


# -- renders ---------------------------------------------------------------------


def _nerf_render(conf, model, spec, mesh, rays, draws):
    images, poses, focal = spec["scene"]
    with torch.no_grad():
        cond = model.encode(images, poses, focal)
    rp = RenderParallel(renderer_of(conf), model, mesh=mesh)
    return cond, rp, rp(cond, rays, draws=draws)


def render_leg(rank, n, spec):
    """NeRF and YOLO renders with rays sharded over every rank, the empty
    inputs, the tensor-parallel renders, and synchronised BatchNorm."""
    out = {}
    mesh = parallel.make_mesh()
    conf, model = build_model(spec["nerf_conf"], spec["nerf_state"])
    cond, rp, got = _nerf_render(conf, model, spec, mesh, spec["nerf_rays"],
                                 spec["nerf_draws"])
    out["nerf"] = to_np(got)
    empty = rp(cond, spec["nerf_rays"][:, :0])
    out["nerf_empty"] = [tuple(t.shape) for t in empty]

    yconf, ymodel = build_model(spec["yolo_conf"], spec["yolo_state"])
    images, poses, focal, c = spec["yolo_scene"]
    with torch.no_grad():
        ycond = ymodel.encode(images, poses, focal, c=c)
    yrp = RenderParallel(renderer_of(yconf), ymodel, mesh=mesh)
    out["yolo"] = to_np(yrp(ycond, spec["yolo_rays"], draws=spec["yolo_u"]))
    out["yolo_empty"] = tuple(yrp(ycond, np.zeros((0, 8), np.float32)).shape)

    # the field split over 'model' (the kernel route's gathered weights and
    # the plain route's split blocks)
    tp_mesh = parallel.make_train_mesh(batch_size=1, model_parallel=2)
    for route, state in spec["tp_states"].items():
        conf_r = dict(spec["nerf_conf"])
        conf_r["model"] = dict(conf_r["model"], use_fused_mlp=route)
        tconf, tmodel = build_model(conf_r, state)
        parallel.shard_model(tmodel, tp_mesh)
        _, _, got = _nerf_render(tconf, tmodel, spec, tp_mesh,
                                 spec["nerf_rays"], spec["tp_draws"])
        out["tp_" + route] = to_np(got)
    out["tp_shapes"] = gather_objects(
        {k: tuple(v.shape) for k, v in tmodel.state_dict().items()
         if "blocks.0.fc" in k})
    out.update(batch_norm_check(rank, spec))
    return out


def batch_norm_check(rank, spec):
    """Synchronised BatchNorm over 'data' of a (data 2, rays 2) mesh: the
    statistics of a (4, C, H, W) map, and the encoder's gradient and
    running statistics after a train-mode encode of 2 scenes, summed over
    the data group."""
    from pixelnerf_yolo_torch.nn.resnet import synced_var_mean

    mesh = parallel.make_train_mesh(batch_size=2)
    group = mesh.get_group(parallel.DATA_AXIS)
    d = parallel.axis_index(mesh, parallel.DATA_AXIS)
    x = torch.as_tensor(spec["bn_x"])
    per = x.shape[0] // 2
    var, mean = synced_var_mean(x[d * per:(d + 1) * per], group)
    conf, model = build_model(spec["nerf_conf"], spec["nerf_state"])
    images, poses, focal = spec["bn_scenes"]
    with collectives.synced_batch_norm(group):
        cond = model.encode(images[d:d + 1], poses[d:d + 1], focal,
                            train=True)
    g = torch.as_tensor(spec["bn_g"])
    rows = g.shape[0] // 2
    (cond.latent_flat.float() * g[d * rows:(d + 1) * rows]).sum().backward()
    grads = {k: p.grad.clone() for k, p in model.encoder.named_parameters()
             if p.grad is not None}
    keys = sorted(grads)
    flat = torch.cat([grads[k].reshape(-1) for k in keys])
    collectives.all_reduce_(flat, group)
    sizes = [grads[k].numel() for k in keys]
    grads = dict(zip(keys, (t.reshape(grads[k].shape).numpy() for k, t in
                            zip(keys, flat.split(sizes)))))
    stats = {k: v.numpy() for k, v in model.encoder.state_dict().items()
             if "running" in k}
    return {"bn_var": var.numpy(), "bn_mean": mean.numpy(),
            "bn_grads": grads, "bn_stats": stats}


# -- training --------------------------------------------------------------------


def train_args(tmp, name, **extra):
    """The trainers' argparse namespace, directories under tmp."""
    args = argparse.Namespace(
        name=name, resume=False, gpu_id=[0], logs_path=f"{tmp}/logs",
        checkpoints_path=f"{tmp}/checkpoints", visual_path=f"{tmp}/visuals",
        epochs=1, lr=1e-4, gamma=1.0, ray_batch_size=32, batch_size=1,
        nviews="3", freeze_enc=None, no_bbox_step=100000, fixed_test=None,
        seed=0)
    for k, v in extra.items():
        setattr(args, k, v)
    for d in (os.path.join(args.checkpoints_path, name),
              os.path.join(args.visual_path, name), args.logs_path):
        os.makedirs(d, exist_ok=True)
    return args


def build_trainer(case, mesh, tmp):
    """The port's trainer of a case (conf dict, weights, dataset root) on
    the CPU over mesh."""
    from pixelnerf_yolo_torch.data import get_split_dataset
    from pixelnerf_yolo_torch.train import make_trainer

    conf, model = build_model(case["conf"], case["state"])
    if case["kind"] == "nerf":
        s = case["size"]
        dset, val = get_split_dataset("srn", case["root"],
                                      image_size=(s, s))[:2]
    else:
        dset, val, _ = get_split_dataset("yolo", case["root"], conf=conf)
    args = train_args(tmp, case["name"], **case["args"])
    return make_trainer(args, conf, dset, val, model, renderer_of(conf),
                        [int(v) for v in args.nviews.split()], device="cpu",
                        mesh=mesh)


def train_leg(rank, n, spec):
    """One update of each case's trainer on its mesh: the reported
    losses, the updated weights in the single-device layout, each rank's
    shard and Adam moment shapes; with "save" the checkpoint written and a
    render after the update."""
    out = {}
    for case in spec["cases"]:
        mesh = parallel.make_train_mesh(batch_size=case["mesh_batch"],
                                        model_parallel=case["mp"])
        tr = build_trainer(case, mesh, spec["tmp"])
        kw = ({"draws": case["draws"]} if case["kind"] == "nerf"
              else {"u": torch.as_tensor(case["u"])})
        losses = tr.train_step(case["batch"], **kw)
        res = {"losses": {k: float(v) for k, v in losses.items()},
               "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
               "state": to_np(parallel.full_state_dict(tr.model))}
        opt = tr.optimizer.state_dict()["state"]
        names = [k for k, _ in tr.model.named_parameters()]
        res["shards"] = gather_objects({
            names[i]: (tuple(dict(tr.model.named_parameters())[names[i]]
                             .shape), tuple(s["exp_avg"].shape),
                       tuple(s["exp_avg_sq"].shape))
            for i, s in opt.items() if "blocks.0.fc" in names[i]})
        if case.get("save"):
            tr.save_model_state()
            res["ckpt"] = os.path.join(tr.args.checkpoints_path,
                                       tr.args.name, "pixel_nerf_latest")
            images, poses, focal = case["scene"]
            with torch.no_grad():
                cond = tr.model.encode(images, poses, focal)
                res["render"] = to_np(RenderParallel(
                    tr.renderer, tr.model, mesh=mesh)(
                        cond, case["rays"], draws=case["render_draws"]))
        out[case["name"]] = res
    return out


def bf16_tp_leg(rank, n, spec):
    """tests/test_torch_parallel_bf16_tp.py's ranks: one bf16
    ResnetBlockFC split over every rank (its output and gradients, the
    weight gradients gathered whole), then one bf16 update of the case on
    its mesh with every gradient gathered whole."""
    from pixelnerf_yolo_torch.nn.resnetfc import ResnetBlockFC

    blk = ResnetBlockFC(spec["block"]["fc_0.weight"].shape[1],
                        dtype=torch.bfloat16)
    blk.load_state_dict({k: torch.as_tensor(v)
                         for k, v in spec["block"].items()})
    plan = parallel.tp_plan(((k, p.shape) for k, p in
                             blk.named_parameters()), n)
    with torch.no_grad():
        for k, p in blk.named_parameters():
            if plan[k] is not None:
                size = p.shape[plan[k]] // n
                p.data = p.data.narrow(plan[k], rank * size, size).clone()
    blk.tp_group = dist.group.WORLD
    x = torch.as_tensor(spec["x"]).to(torch.bfloat16).requires_grad_(True)
    y = blk(x)
    (y.float() * torch.as_tensor(spec["gy"])).sum().backward()
    out = {"block": {
        "y": to_np(y), "x_grad": to_np(x.grad),
        "grads": {k: to_np(parallel.gather_tp(p.grad, plan[k],
                                              dist.group.WORLD))
                  for k, p in blk.named_parameters()}}}

    case = spec["case"]
    mesh = parallel.make_train_mesh(batch_size=case["mesh_batch"],
                                    model_parallel=case["mp"])
    tr = build_trainer(case, mesh, spec["tmp"])
    losses = tr.train_step(case["batch"], u=torch.as_tensor(case["u"]))
    group = parallel.model_group(tr.model)
    out["losses"] = {k: float(v) for k, v in losses.items()}
    out["grads"] = {
        k: to_np(parallel.gather_tp(p.grad, parallel._tp_dim(k, p.ndim),
                                    group))
        for k, p in tr.model.named_parameters() if p.grad is not None}
    out["state"] = to_np(parallel.full_state_dict(tr.model))
    return out
