"""Detection evaluation: precision, recall, F1 and mAP@0.5 over the test
split, or a per-scale threshold calibration.

    python -m pixelnerf_yolo_torch.eval.eval_yolo -n <name> -c <conf> \
        -D <data> -F yolo -V 3 [--calibrate_scales 0.45,0.6,0.75,0.9] \
        [--host_nms] [--device cuda]

Counterpart of the repo's eval/eval_yolo.py: the same flags and the same
printed table, on the card unless ``--device cpu``; a ``--gpu_id`` list
shards the renders over one rank an id.
"""

from __future__ import annotations

from .. import parallel
from ..config.args import parse_args
from ..data import DataLoader, get_split_dataset
from ..detect.boxes import calculate_precision_recall_f1
from ..models import make_model
from ..render import make_renderer
from ..train import make_trainer
from ..utils.misc import count_parameters
from ._common import add_device_arg


def extra_args(parser):
    parser.add_argument("--batch_size", "-B", type=int, default=4,
                        help="Object batch size ('SB')")
    parser.add_argument("--nviews", "-V", type=str, default="1",
                        help="Number of source views (multiview)")
    parser.add_argument("--freeze_enc", action="store_true", default=None,
                        help="Freeze encoder weights and only train MLP")
    parser.add_argument("--no_bbox_step", type=int, default=100000,
                        help="Step to stop using bbox sampling")
    parser.add_argument("--fixed_test", action="store_true", default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--host_nms", action="store_true",
                        help="Use the reference-exact host list NMS for "
                        "metrics instead of the padded device NMS")
    parser.add_argument("--calibrate_scales", default=None,
                        help="Comma-separated confidence grid (e.g. "
                        "'0.45,0.6,0.75,0.9'): render the metric "
                        "protocol once, then grid-search per-scale "
                        "confidence pre-filters (yolo."
                        "nms_threshold_per_scale) and report each "
                        "combo's F1 + mAP@0.5.  Eval-time calibration "
                        "for multi-scale confs — no retrain.")
    return add_device_arg(parser)


def build_trainer(args, conf, splits=None):
    """The YOLO trainer over the conf's datasets (or the given (train, val,
    test) splits), with the trained weights
    (checkpoints/<name>/pixel_nerf_latest), its renders sharded over the
    ranks when there are several; returns (trainer, test set)."""
    if splits is None:
        splits = get_split_dataset(args.dataset_format, args.datadir,
                                   conf=conf)
    dset, val_dset, test_dset = splits
    print("dset z_near {}, z_far {}, lindisp {}".format(
        dset.z_near, dset.z_far, getattr(dset, "lindisp", "N/A")))
    model = make_model(conf.get_config("model"), device=args.device,
                       load_pretrained=False)
    renderer = make_renderer(conf, lindisp=getattr(dset, "lindisp", False),
                             device=args.device)
    nviews = list(map(int, args.nviews.split()))
    args.resume = True  # evaluation always loads the trained weights
    trainer = make_trainer(args, conf, dset, val_dset, model, renderer,
                           nviews, device=args.device,
                           mesh=parallel.default_mesh())
    print("Number of model parameters:",
          count_parameters(trainer.model))
    return trainer, test_dset


def evaluate(trainer, test_dset, calibrate=None):
    """The metric protocol over test_dset, one scene at a time.

    :param calibrate None, or the confidence grid of ``calibrate_scales``
    :return {"precision", "recall", "f1", "map50", "per_class", "tp",
      "fp", "fn"}, or with calibrate {"results", "best"} as
      calibrate_scales returns them
    """
    loader = DataLoader(test_dset, batch_size=1, shuffle=False)
    if calibrate is not None:
        results, best = trainer.calibrate_scales(loader, calibrate)
        return {"results": results, "best": best}
    (tp, fp, fn), (map50, per_class) = trainer.metric_counts_and_map(
        loader, iou_threshold=0.5, print_hc=True)
    precision, recall, f1 = calculate_precision_recall_f1(tp, fp, fn)
    return {"precision": precision, "recall": recall, "f1": f1,
            "map50": map50, "per_class": per_class, "tp": tp, "fp": fp,
            "fn": fn}


def main(argv=None):
    args, conf = parse_args(extra_args, training=True,
                            default_ray_batch_size=128, argv=argv)
    return parallel.launch(run, args, conf)


def run(args, conf):
    """The evaluation on one rank."""
    trainer, test_dset = build_trainer(args, conf)

    print("\n------------ Eval ------------")
    if args.calibrate_scales:
        grid = [float(t) for t in args.calibrate_scales.split(",")]
        cal = evaluate(trainer, test_dset, calibrate=grid)
        results, best = cal["results"], cal["best"]
        print("taus\tP\tR\tF1\tmAP@0.5\tTP/FP/FN")
        for r in sorted(results, key=lambda r: (-r["f1"], -r["map50"])):
            print("{}\t{:.3f}\t{:.3f}\t{:.3f}\t{:.4f}\t{}/{}/{}".format(
                ",".join(f"{t:g}" for t in r["taus"]), r["precision"],
                r["recall"], r["f1"], r["map50"], r["tp"], r["fp"],
                r["fn"],
            ))
        print("best per-scale thresholds: [{}]  F1 {:.3f}  mAP@0.5 "
              "{:.4f}  (set yolo.nms_threshold_per_scale)".format(
                  ", ".join(f"{t:g}" for t in best["taus"]),
                  best["f1"], best["map50"]))
        return cal
    m = evaluate(trainer, test_dset)
    print("Precision\tRecall\tF1\tmAP@0.5")
    print("{}\t{}\t{}\t{:.4f}".format(m["precision"], m["recall"], m["f1"],
                                      m["map50"]))
    for cls, ap in m["per_class"].items():
        print("  AP@0.5 class {}: {:.4f}".format(cls, ap))
    return m


if __name__ == "__main__":
    main()
