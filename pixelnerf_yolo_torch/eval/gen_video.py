"""Novel-view trajectory video: a 360-degree orbit (or, with
--dtu_trajectory, IDR's DTU fly-through) rendered from an object's source
views.

    python -m pixelnerf_yolo_torch.eval.gen_video -n <name> -c <conf> \
        -D <data> -F srn -P "64" [--dtu_trajectory] [--device cuda]

Counterpart of the repo's eval/gen_video.py, with its flags and outputs
(visuals/<name>/v<name>_v<sources>.mp4, or .gif where imageio has no mp4
writer, and the source-view sheet video..._view.jpg).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import parallel
from ..config.args import parse_args
from ..data import get_split_dataset
from ..render.nerf import NeRFRenderer
from ..utils import camera
from ._common import (
    add_device_arg,
    load_model,
    render_rays,
    write_video,
)


def extra_args(parser):
    parser.add_argument("--subset", "-S", type=int, default=0,
                        help="Subset in data to use")
    parser.add_argument("--split", type=str, default="train",
                        help="Split of data to use train | val | test")
    parser.add_argument("--source", "-P", type=str, default="64",
                        help="Source view(s) in image, in increasing order. "
                        "-1 to do random")
    parser.add_argument("--num_views", type=int, default=40,
                        help="Number of video frames (rotated views)")
    parser.add_argument("--elevation", type=float, default=-10.0,
                        help="Elevation angle (negative is above)")
    parser.add_argument("--scale", type=float, default=1.0,
                        help="Video scale relative to input size")
    parser.add_argument("--radius", type=float, default=0.0,
                        help="Distance of camera from origin, default is "
                        "average of z_far, z_near of dataset (non-DTU)")
    parser.add_argument("--fps", type=int, default=30, help="FPS of video")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--dtu_trajectory", action="store_true",
        help="Use the IDR DTU fly-through (periodic quaternion spline) "
        "instead of the 360 orbit.")
    return add_device_arg(parser)


def trajectory(num_views: int, elevation: float, radius: float,
               dtu: bool = False) -> np.ndarray:
    """(F, 4, 4) camera-to-world poses: the orbit ring, or the DTU
    fly-through (F = 6 * max(num_views // 5, 1))."""
    if dtu:
        return camera.dtu_trajectory(num_views)
    return np.stack([
        camera.pose_spherical(angle, elevation, radius)
        for angle in np.linspace(-180, 180, num_views + 1)[:-1]
    ])


def render_video(model, renderer, data, source, render_poses, z_near: float,
                 z_far: float, scale: float = 1.0,
                 ray_batch_size: int = 50000, seed: int = 0):
    """Frames (F, H, W, 3) in [0, 1] of render_poses, from the source views
    of one dataset item (images, poses, focal and c of one object)."""
    images = np.asarray(data["images"])  # (NV, 3, H, W)
    poses = np.asarray(data["poses"])
    focal = np.asarray(data["focal"], dtype=np.float32)
    c = np.asarray(data["c"], dtype=np.float32) if "c" in data else None
    _, _, H, W = images.shape
    if scale != 1.0:
        H, W = int(H * scale), int(W * scale)
    rays = camera.gen_rays(
        torch.from_numpy(np.asarray(render_poses, dtype=np.float32)), W, H,
        torch.as_tensor(focal * scale), z_near, z_far,
        c=torch.as_tensor(c * scale) if c is not None else None,
    ).reshape(-1, 8).numpy()
    with torch.no_grad():
        # (2,) focal and c with a leading 1: (fx, fy), not two views
        cond = model.encode(images[source][None], poses[source][None],
                            focal[None], c=c[None] if c is not None else None)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    rgb, _ = render_rays(renderer, model, cond, rays, ray_batch_size, gen)
    return np.clip(rgb.reshape(len(render_poses), H, W, 3), 0, 1)


def main(argv=None):
    args, conf = parse_args(extra_args, argv=argv)
    return parallel.launch(run, args, conf)


def run(args, conf):
    """The video on one rank (only rank 0 writes it)."""
    dset = get_split_dataset(args.dataset_format, args.datadir,
                             want_split=args.split, training=False)
    data = dset[args.subset]
    print("Data instance loaded:", data["path"])
    NV = np.asarray(data["images"]).shape[0]

    model = load_model(args, conf, args.device)
    renderer = NeRFRenderer.from_conf(
        conf.get_config("renderer"), lindisp=getattr(dset, "lindisp", False),
        eval_batch_size=args.ray_batch_size, device=args.device)
    z_near, z_far = dset.z_near, dset.z_far
    if args.dtu_trajectory:
        print("Using DTU camera trajectory")
    radius = args.radius if args.radius > 0 else (z_near + z_far) * 0.5
    render_poses = trajectory(args.num_views, args.elevation, radius,
                              dtu=args.dtu_trajectory)
    if args.source == "-1":
        rng = np.random.default_rng(args.seed)
        source = np.array([rng.integers(0, NV)])
    else:
        source = np.array(sorted(map(int, args.source.split())))
    print("Using source views:", source)
    frames = render_video(model, renderer, data, source, render_poses,
                          z_near, z_far, scale=args.scale,
                          ray_batch_size=args.ray_batch_size, seed=args.seed)
    if not parallel.is_main():
        return frames

    import imageio

    print("Writing video")
    vid_name = "v" + args.name + "_v{}".format(
        "_".join(map(str, source.tolist())))
    out_dir = os.path.join(args.visual_path, args.name)
    os.makedirs(out_dir, exist_ok=True)
    vid_path = write_video(os.path.join(out_dir, vid_name + ".mp4"),
                           (frames * 255).astype(np.uint8), args.fps)
    viewimg_path = os.path.join(out_dir, "video" + vid_name + "_view.jpg")
    images = np.asarray(data["images"])
    img_np = (images[source] * 0.5 + 0.5).transpose(0, 2, 3, 1)
    img_np = np.hstack(list(img_np))
    imageio.imwrite(viewimg_path, (img_np * 255).astype(np.uint8))
    print("Wrote to", vid_path, "view:", viewimg_path)
    return frames


if __name__ == "__main__":
    main()
