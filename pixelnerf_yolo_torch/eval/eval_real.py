"""Render an orbit from one real photo (the output of the repo's
scripts/preproc.py, ``*_normalize.png``) seen by a dummy identity camera.

    python -m pixelnerf_yolo_torch.eval.eval_real -n <name> -c <conf> \
        -I input/car_normalize.png -O output [--gif] [--device cuda]

Counterpart of the repo's eval/eval_real.py, with its flags and outputs
(<output>/<base>_NNNN.png and <base>_vid.mp4 or .gif).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import parallel
from ..config.args import parse_args
from ..render.nerf import NeRFRenderer
from ..utils import camera
from ..utils.image import image_to_tensor_balanced
from ._common import (
    add_device_arg,
    load_model,
    render_rays,
    write_video,
)


def extra_args(parser):
    parser.add_argument("--input", "-I", type=str,
                        default=os.path.join("input", "car_normalize.png"),
                        help="Input image (normalized by scripts/preproc.py)")
    parser.add_argument("--output", "-O", type=str, default="output",
                        help="Output directory")
    parser.add_argument("--size", type=int, default=128,
                        help="Input image maxdim")
    parser.add_argument("--out_size", type=str, default="128",
                        help="Output image size, either 1 or 2 numbers")
    parser.add_argument("--focal", type=float, default=131.25,
                        help="Focal length")
    parser.add_argument("--radius", type=float, default=1.3,
                        help="Camera distance")
    parser.add_argument("--z_near", type=float, default=0.8)
    parser.add_argument("--z_far", type=float, default=1.8)
    parser.add_argument("--elevation", type=float, default=-10.0,
                        help="Elevation angle (negative is above)")
    parser.add_argument("--num_views", type=int, default=24,
                        help="Number of video frames")
    parser.add_argument("--fps", type=int, default=15, help="FPS of video")
    parser.add_argument("--gif", action="store_true",
                        help="Store gif instead of mp4")
    parser.add_argument("--no_vid", action="store_true",
                        help="Skip writing the video, only frames")
    parser.add_argument("--seed", type=int, default=0)
    return add_device_arg(parser)


def render_orbit(model, renderer, image, focal: float, radius: float,
                 elevation: float, num_views: int, out_w: int, out_h: int,
                 z_near: float, z_far: float, ray_batch_size: int,
                 seed: int = 0):
    """The orbit frames (num_views, out_h, out_w, 3) in [0, 1] of one
    (3, H, W) source image in [-1, 1] at an identity camera pulled back by
    radius, with the blender-to-camera turn on each orbit pose."""
    W = image.shape[-1]
    cam_pose = np.eye(4, dtype=np.float32)
    cam_pose[2, 3] = radius
    with torch.no_grad():
        cond = model.encode(image[None][None], cam_pose[None][None],
                            np.float32(focal))
    render_poses = np.stack([
        camera.coord_from_blender()
        @ camera.pose_spherical(angle, elevation, radius)
        for angle in np.linspace(-180, 180, num_views + 1)[:-1]
    ])
    scale = out_w / W
    rays = camera.gen_rays(torch.from_numpy(render_poses), out_w, out_h,
                           torch.tensor(np.float32(focal) * scale), z_near,
                           z_far).reshape(-1, 8).numpy()
    gen = torch.Generator(device=model.device).manual_seed(seed)
    rgb, _ = render_rays(renderer, model, cond, rays, ray_batch_size, gen)
    return np.clip(rgb.reshape(num_views, out_h, out_w, 3), 0, 1)


def main(argv=None):
    args, conf = parse_args(extra_args, default_expname="srn_car",
                            default_data_format="srn", argv=argv)
    return parallel.launch(run, args, conf)


def run(args, conf):
    """The orbit on one rank (only rank 0 writes the frames)."""
    model = load_model(args, conf, args.device)
    renderer = NeRFRenderer.from_conf(conf.get_config("renderer"),
                                      eval_batch_size=args.ray_batch_size,
                                      device=args.device)
    import cv2
    import imageio.v2 as imageio

    img = imageio.imread(args.input)[..., :3]
    img = cv2.resize(img, (args.size, args.size),
                     interpolation=cv2.INTER_AREA)
    image = image_to_tensor_balanced(img)  # (3, H, W) in [-1, 1]
    out_sizes = list(map(int, args.out_size.split()))
    frames = render_orbit(
        model, renderer, image, args.focal, args.radius, args.elevation,
        args.num_views, out_sizes[0], out_sizes[-1], args.z_near, args.z_far,
        args.ray_batch_size, seed=args.seed)
    if not parallel.is_main():
        return frames

    os.makedirs(args.output, exist_ok=True)
    base = os.path.splitext(os.path.basename(args.input))[0]
    frames_u8 = (frames * 255).astype(np.uint8)
    for i, fr in enumerate(frames_u8):
        imageio.imwrite(os.path.join(args.output, f"{base}_{i:04d}.png"), fr)
    if not args.no_vid:
        if args.gif:
            vid_path = os.path.join(args.output, base + "_vid.gif")
            imageio.mimwrite(vid_path, frames_u8, fps=args.fps)
        else:
            vid_path = write_video(
                os.path.join(args.output, base + "_vid.mp4"), frames_u8,
                args.fps)
        print("Wrote", vid_path)
    return frames


if __name__ == "__main__":
    main()
