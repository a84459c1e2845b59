"""Training entry point of the port:

    python -m pixelnerf_yolo_torch.train -c conf/exp/yolo.conf -D <data> \
        -F yolo -n <name> [-B 1] [-V 3] [--device cuda]

Counterpart of the repo's train/train.py with its flags (-B, -V,
--freeze_enc, --no_bbox_step, --fixed_test, --seed, --host_nms): the
NaN-abort stop and the early-restart loop (rebuild everything with
resume=False when the trainer reports "no_vis").  It trains on one
device, the card unless ``--device cpu`` is given; the YOLO trainer is
ported, the NeRF trainer is not yet (ROADMAP.md Queue 1 item 16).
"""

from __future__ import annotations

from ..config.args import parse_args
from ..data import get_split_dataset
from ..models import make_model
from ..render import make_renderer
from . import make_trainer


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
    parser.add_argument("--host_nms", action="store_true",
                        help="Use the host list NMS for metric intervals "
                        "instead of the padded device NMS")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (cuda or cpu)")
    return parser


def build_and_train(args, conf, resume):
    if len(args.gpu_id) > 1:
        raise NotImplementedError(
            "multi-GPU training is not ported yet (ROADMAP.md Queue 1 item "
            "20)")
    args.resume = resume
    dset, val_dset, _ = get_split_dataset(args.dataset_format, args.datadir,
                                          conf=conf)
    print("dset z_near {}, z_far {}, lindisp {}".format(
        dset.z_near, dset.z_far, getattr(dset, "lindisp", False)))
    model = make_model(conf.get_config("model"), device=args.device,
                       seed=args.seed, stop_encoder_grad=bool(args.freeze_enc))
    if args.freeze_enc:
        print("Encoder frozen")
    renderer = make_renderer(conf, lindisp=getattr(dset, "lindisp", False),
                             device=args.device)
    nviews = list(map(int, args.nviews.split()))
    trainer = make_trainer(args, conf, dset, val_dset, model, renderer,
                           nviews, device=args.device)
    return trainer.start()


def main(argv=None):
    args, conf = parse_args(extra_args, training=True,
                            default_ray_batch_size=128, argv=argv)
    stop = build_and_train(args, conf, resume=args.resume)
    while stop == "no_vis":
        print("Restarting training from scratch (early_restart)")
        stop = build_and_train(args, conf, resume=False)
    if stop == "nan":
        print("Stopped after NaN loss")
    return stop


if __name__ == "__main__":
    main()
