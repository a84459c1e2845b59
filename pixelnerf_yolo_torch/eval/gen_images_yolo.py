"""Detection panels: asks for NMS thresholds in a loop and writes one
annotated panel (sources, destination, ground truth, predictions) a round.

    python -m pixelnerf_yolo_torch.eval.gen_images_yolo -n <name> \
        -c <conf> -D <data> -F yolo -V 3 -P "0 2 3" --dest 0 [--device cuda]

Counterpart of the repo's eval/gen_images_yolo.py: the same flags and file
names (visuals/yolo_vis/<subset>_<dest>_vis_<nmsiou>_<nmst>.png); input
that is not a number ends the loop.
"""

from __future__ import annotations

import os

import numpy as np

from .. import parallel
from ..config.args import parse_args
from ..data import DataLoader
from ._common import add_device_arg, read_floats
from .eval_yolo import build_trainer


def extra_args(parser):
    parser.add_argument("--batch_size", "-B", type=int, default=4,
                        help="Object batch size ('SB')")
    parser.add_argument("--nviews", "-V", type=str, default="1",
                        help="Number of source views (multiview)")
    parser.add_argument("--freeze_enc", action="store_true", default=None)
    parser.add_argument("--no_bbox_step", type=int, default=100000)
    parser.add_argument("--fixed_test", action="store_true", default=None)
    parser.add_argument("--subset", "-S", type=int, default=0,
                        help="Subset in data to use")
    parser.add_argument("--source", "-P", type=str, default="0",
                        help="Source view(s) in image, in increasing order.")
    parser.add_argument("--dest", type=int, default=0,
                        help="Destination view to use")
    parser.add_argument("--seed", type=int, default=0)
    return add_device_arg(parser)


def render_panel(trainer, data, source, dest: int, nmst: float,
                 nmsiou: float):
    """The annotated panel (H, W_total, 3) in [0, 1] of one destination
    view at these thresholds, or None when early_restart finds no box."""
    trainer.nms_threshold = nmst
    trainer.nms_iou_threshold = nmsiou
    vis, _ = trainer.vis_step(data, idx=0, srcs=np.asarray(source),
                              dest=dest)
    return vis


def main(argv=None):
    args, conf = parse_args(extra_args, training=True,
                            default_ray_batch_size=128, argv=argv)
    return parallel.launch(run, args, conf)


def run(args, conf):
    """The panel loop on one rank: rank 0 reads the thresholds and writes
    the panels."""
    trainer, test_dset = build_trainer(args, conf)

    print("\n------------ Generating images ------------")
    data = next(iter(DataLoader(test_dset, batch_size=1, shuffle=False)))
    source = np.array(args.source.split(), dtype="int")
    dest = args.dest
    written = []
    while True:
        values = read_floats(("Enter nmst: ", "Enter nmsiou: "))
        if values is None:
            break
        nmst, nmsiou = values
        vis = render_panel(trainer, data, source, dest, nmst, nmsiou)
        if vis is None or not parallel.is_main():
            continue
        import imageio

        out_dir = os.path.join(args.visual_path, "yolo_vis")
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "{:04}_{:04}_vis_{}_{}.png".format(
            args.subset, dest, nmsiou, nmst))
        imageio.imwrite(path, (np.clip(vis, 0, 1) * 255).astype(np.uint8))
        written.append(path)
    return written


if __name__ == "__main__":
    main()
