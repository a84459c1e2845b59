"""A one-step multi-rank dry run of the port: the shipped YOLO trainer's
sharded update on the full mesh, then a 1-vs-N ray-sharded render.

    python -m pixelnerf_yolo_torch.parallel.dryrun --n 8 --device cpu
    python -m pixelnerf_yolo_torch.parallel.dryrun --n 2 --device cuda

Counterpart of ``dryrun_multichip`` in the repo's __graft_entry__.py, on n
ranks (``parallel.launch``): one train step of ``YOLOTrainer`` on the
on-disk dataset of tests/synth_data.py (its copy in ``_synth``) over
``make_train_mesh(n, batch_size, model_parallel)``, with batch_size 2
when n is even (a 'data' axis of 2) and model_parallel 2 when 4 divides
n: (2, 2, 2) at 8 ranks.  It checks a
finite loss, moved weights and, under tensor parallelism, that each rank
holds its fc_0 / fc_1 shards and their Adam moments.  Then the NeRF
flagship at test width renders 256 rays on one rank and sharded over all
n, which must agree (rtol 2e-5, atol 1e-6).  Under ``--device cuda`` rank
r runs on cuda:<r mod the card count>, so ranks share cards where there
are fewer than n (over gloo); reading the dataset needs imageio and cv2.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from . import (MODEL_AXIS, axis_size, full_state_dict, launch, make_mesh,
               make_train_mesh)
from ._synth import make_yolo_dataset
from .render import RenderParallel

# the repo's dry-run YOLO trainer conf (__graft_entry__._DRYRUN_YOLO_CONF):
# resnet18 with 2 layers, a 5-block 64-wide ResnetFC, 16 coarse samples,
# 16-ray chunks
DRYRUN_YOLO_CONF = """
model {
    use_encoder = True
    use_xyz = True
    use_code = True
    code { num_freqs = 6
           freq_factor = 1.5
           include_input = True }
    use_viewdirs = True
    use_code_viewdirs = False
    mlp_coarse { type = resnet
                 n_blocks = 5
                 d_hidden = 64
                 combine_layer = 3
                 combine_type = average
                 d_out = 7
                 num_scales = 1
                 num_anchors_per_scale = 3
                 yolo = True }
    mlp_fine { type = empty }
    encoder { backbone = resnet18
              pretrained = False
              num_layers = 2
              index_padding = zeros }
}
renderer { type = yolo
           n_coarse = 16
           n_fine = 0
           white_bkgd = False
           eval_batch_size = 128 }
loss { lambda_coarse = 1.0 }
train { print_interval = 2
        save_interval = 10000
        backup_interval = 10000
        vis_interval = 10000
        eval_interval = 10000
        metric_interval = 10000
        accu_grad = 1
        num_epoch_repeats = 1 }
yolo {
    image_scale = [0.5, 0.5]
    cell_sizes = [32]
    anchors = [
        [[0.02, 0.03], [0.04, 0.07], [0.08, 0.06]],
        [[0.07, 0.15], [0.15, 0.11], [0.14, 0.29]],
        [[0.28, 0.22], [0.38, 0.48], [0.9, 0.78]]
    ]
    ignore_iou_thresh = 0.5
    ray_batch_size = 16
    weights { box_loss = 1
              object_loss = 20
              no_object_loss = 1
              class_loss = 1 }
    early_restart = False
    nms_iou_threshold = 0.75
    nms_threshold = 0.45
    metric_views = [[0,2,3]]
    match_iou_threshold = 0.2
}
"""


def _trainer_leg(args, root):
    from ..config.hocon import parse_string
    from ..data import get_split_dataset
    from ..models import make_model
    from ..render import make_renderer
    from ..train import make_trainer

    conf = parse_string(DRYRUN_YOLO_CONF)
    n = len(args.gpu_id)
    mp = 2 if n % 4 == 0 else 1
    dset, val_dset, _ = get_split_dataset("yolo", root, conf=conf)
    model = make_model(conf.get_config("model"), device=args.device,
                       load_pretrained=False)
    mesh = make_train_mesh(batch_size=args.batch_size, model_parallel=mp)
    trainer = make_trainer(args, conf, dset, val_dset, model,
                           make_renderer(conf, device=args.device), [3],
                           device=args.device, mesh=mesh)
    before = {k: v.clone() for k, v in full_state_dict(trainer.model).items()}
    batch = next(iter(trainer.train_data_loader))
    loss = float(trainer.train_step(batch)["t"])
    assert np.isfinite(loss), f"non-finite loss in the dry run: {loss}"
    after = full_state_dict(trainer.model)
    delta = sum(float((after[k].float() - v.float()).abs().sum())
                for k, v in before.items())
    assert delta > 0, "the optimizer step changed nothing"
    if axis_size(mesh, MODEL_AXIS) > 1:
        H = conf.get_int("model.mlp_coarse.d_hidden")
        params = dict(trainer.model.named_parameters())
        state = trainer.optimizer.state
        for name, p in params.items():
            if name.endswith("fc_0.weight"):
                assert p.shape[0] == H // mp, (name, tuple(p.shape))
                assert state[p]["exp_avg"].shape == p.shape, name
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    print(f"dryrun OK: YOLOTrainer mesh={shape} ranks={n} loss={loss:.4f} "
          f"param_delta={delta:.3e}", flush=True)


def _render_leg(args):
    from ..config.flagship import flagship_conf
    from ..models import make_model
    from ..render import make_renderer
    from ..utils.camera import gen_rays

    n = len(args.gpu_id)
    conf = flagship_conf(d_hidden=64, backbone="resnet18", num_layers=2)
    model = make_model(conf.get_config("model"), device=args.device,
                       seed=0, load_pretrained=False)
    renderer = make_renderer(conf, device=args.device)
    rng = np.random.default_rng(0)
    images = rng.normal(size=(1, 1, 3, 64, 64)).astype(np.float32)
    poses = np.eye(4, dtype=np.float32)[None, None].copy()
    poses[..., 2, 3] = 1.3
    focal = np.float32(60.0)
    rays = gen_rays(torch.from_numpy(poses[0]), 16, 16, torch.tensor(focal),
                    0.8, 1.8).reshape(1, -1, 8)
    with torch.no_grad():
        cond = model.encode(images, poses, focal)
    gen = torch.Generator(device=args.device).manual_seed(1)
    draws = renderer.draw(rays.shape[1], gen, args.device)
    one = renderer(model, cond, rays, draws=draws)
    many = RenderParallel(renderer, model, mesh=make_mesh())(cond, rays,
                                                              draws=draws)
    for p in one:
        for k in one[p]:
            np.testing.assert_allclose(
                many[p][k].float().cpu().numpy(),
                one[p][k].float().cpu().numpy(), rtol=2e-5, atol=1e-6,
                err_msg=f"render leg diverged at {p}/{k}")
    print(f"dryrun OK: RenderParallel 1-vs-{n} ranks allclose on the "
          f"('rays',) mesh ({rays.shape[1]} rays, coarse + fine NeRF)",
          flush=True)


def run(args, root):
    """Both legs on one rank."""
    if args.device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // len(args.gpu_id)))
    _trainer_leg(args, root)
    _render_leg(args)
    return "done"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=8, help="ranks")
    parser.add_argument("--device", default="cuda",
                        help="cuda (rank r on cuda:<r mod cards>) or cpu")
    opts = parser.parse_args(argv)
    n = opts.n
    if opts.device == "cpu":
        ids = list(range(n))
    else:
        cards = torch.cuda.device_count()
        if cards == 0:
            raise SystemExit("--device cuda needs a card")
        ids = [r % cards for r in range(n)]
    with tempfile.TemporaryDirectory() as tmp:
        root = make_yolo_dataset(os.path.join(tmp, "data"), n_scenes=2,
                                 n_views=4, img_size=64)
        args = argparse.Namespace(
            name="dryrun", resume=False, gpu_id=ids, device=opts.device,
            logs_path=os.path.join(tmp, "logs"),
            checkpoints_path=os.path.join(tmp, "checkpoints"),
            visual_path=os.path.join(tmp, "visuals"), epochs=1, lr=1e-4,
            gamma=1.0, ray_batch_size=32, batch_size=2 if n % 2 == 0 else 1,
            nviews="3", freeze_enc=None, no_bbox_step=100000,
            fixed_test=None, seed=0)
        for p in (args.logs_path, args.visual_path,
                  os.path.join(args.checkpoints_path, args.name)):
            os.makedirs(p, exist_ok=True)
        return launch(run, args, root)


if __name__ == "__main__":
    main()
