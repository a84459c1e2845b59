"""Training entry point of the port:

    python -m pixelnerf_yolo_torch.train -c conf/exp/srn.conf -D <data> \
        -F srn -n <name> [-B 4] [-V 1] [--device cuda]
    python -m pixelnerf_yolo_torch.train -c conf/exp/yolo.conf -D <data> \
        -F yolo -n <name> [-B 1] [-V 3] [--device cuda] \
        [--gpu_id "0 1 2 3"] [--model_parallel 2]

Counterpart of the repo's train/train.py with its flags (-B, -V,
--freeze_enc, --no_bbox_step, --fixed_test, --seed, --model_parallel,
--host_nms): the NaN-abort stop and the early-restart loop (rebuild
everything with resume=False when the trainer reports "no_vis").  It
trains on the card unless ``--device cpu`` is given: the NeRF trainer for
the srn, dvr, dvr_gen, dvr_dtu and multi_obj formats (``renderer.type =
nerf``), the YOLO trainer for yolo.  The ``encoder.pretrained`` graft is
skipped when a checkpoint will overwrite the weights.

A ``--gpu_id`` list of N ids trains on N ranks, one process each
(``parallel.launch``; under torchrun the ranks are torchrun's) over the
``('data', 'rays'[, 'model'])`` mesh of ``parallel.make_train_mesh``; every
rank runs the loop and the early-restart decision on the same reduced
losses and renders.  One id trains on one device, as before.
"""

from __future__ import annotations

from .. import parallel
from ..config.args import parse_args
from ..data import get_split_dataset
from ..models import make_model
from ..render import make_renderer
from . import checkpoints, make_trainer


def extra_args(parser):
    parser.add_argument(
        "--batch_size", "-B", type=int, default=4, help="Object batch size ('SB')"
    )
    parser.add_argument(
        "--nviews", "-V", type=str, default="1",
        help="Number of source views (multiview); '1 2 3' for random",
    )
    parser.add_argument(
        "--freeze_enc", action="store_true", default=None,
        help="Freeze encoder weights and only train MLP",
    )
    parser.add_argument(
        "--no_bbox_step", type=int, default=100000,
        help="Step to stop using bbox sampling",
    )
    parser.add_argument(
        "--fixed_test", action="store_true", default=None,
        help="Visualize the first test batch every time",
    )
    parser.add_argument("--seed", type=int, default=0, help="PRNG seed")
    parser.add_argument(
        "--model_parallel", type=int, default=1,
        help="Tensor-parallel degree: shard the field MLP's hidden dim "
        "over a 'model' mesh axis (fc_0 column- / fc_1 row-parallel; must "
        "divide the --gpu_id count and d_hidden)",
    )
    parser.add_argument("--host_nms", action="store_true",
                        help="Use the host list NMS for metric intervals "
                        "instead of the padded device NMS")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (cuda or cpu)")
    return parser


def build_trainer(args, conf, resume, splits=None):
    """The trainer of the conf over (train, val, test) splits, read from
    args.datadir unless given (datasets held in memory)."""
    args.resume = resume
    if splits is None:
        splits = get_split_dataset(args.dataset_format, args.datadir,
                                   conf=conf)
    dset, val_dset, _ = splits
    print("dset z_near {}, z_far {}, lindisp {}".format(
        dset.z_near, dset.z_far, getattr(dset, "lindisp", False)))
    model = make_model(conf.get_config("model"), device=args.device,
                       seed=args.seed, stop_encoder_grad=bool(args.freeze_enc),
                       load_pretrained=not checkpoints.has_weights(args))
    if args.freeze_enc:
        print("Encoder frozen")
    renderer = make_renderer(conf, lindisp=getattr(dset, "lindisp", False),
                             device=args.device)
    nviews = list(map(int, args.nviews.split()))
    # the ('data', 'rays'[, 'model']) mesh of the ranks; one rank trains
    # unsharded
    n = parallel.world_size()
    parallel.train_mesh_shape(n if n > 1 else len(args.gpu_id),
                              args.batch_size,
                              getattr(args, "model_parallel", 1))
    mesh = None
    if parallel.world_size() > 1:
        mesh = parallel.make_train_mesh(
            batch_size=args.batch_size,
            model_parallel=getattr(args, "model_parallel", 1))
        print("training mesh", dict(zip(mesh.mesh_dim_names, mesh.shape)))
    return make_trainer(args, conf, dset, val_dset, model, renderer,
                        nviews, device=args.device, mesh=mesh)


def build_and_train(args, conf, resume):
    return build_trainer(args, conf, resume).start()


def main(argv=None):
    args, conf = parse_args(extra_args, training=True,
                            default_ray_batch_size=128, argv=argv)
    return parallel.launch(train, args, conf)


def train(args, conf):
    """The training loop with its early restarts, on one rank."""
    stop = build_and_train(args, conf, resume=args.resume)
    while stop == "no_vis":
        print("Restarting training from scratch (early_restart)")
        stop = build_and_train(args, conf, resume=False)
    if stop == "nan":
        print("Stopped after NaN loss")
    return stop


if __name__ == "__main__":
    main()
