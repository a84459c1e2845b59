"""Approximate PSNR and SSIM for development: one random target view per
object.

    python -m pixelnerf_yolo_torch.eval.eval_approx -n <name> -c <conf> \
        -D <data> -F srn --split val -P "64" [--device cuda]

Counterpart of the repo's eval/eval_approx.py, with its flags (-P -1 picks
one random source view per object).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import parallel
from ..config.args import parse_args
from ..data import DataLoader, get_split_dataset
from ..utils import camera
from ..utils.metrics import psnr as psnr_fn, ssim as ssim_fn
from ..parallel.render import RenderParallel
from ._common import add_device_arg, load_model
from .eval import eval_renderer


def extra_args(parser):
    parser.add_argument("--split", type=str, default="val",
                        help="Split of data to use train | val | test")
    parser.add_argument("--source", "-P", type=str, default="64",
                        help="Source view(s), increasing order. -1 = random 1")
    parser.add_argument("--batch_size", type=int, default=4, help="Batch size")
    parser.add_argument("--seed", type=int, default=1234,
                        help="Random seed for target view selection")
    parser.add_argument("--coarse", action="store_true",
                        help="Coarse network as fine")
    return add_device_arg(parser)


def evaluate(model, renderer, dset, source, batch_size: int = 4,
             seed: int = 1234):
    """One random target view per object, rendered batch_size objects at
    a time from the given source views (source [-1]: one random view).

    :return (mean PSNR, mean SSIM)
    """
    gen = torch.Generator(device=model.device).manual_seed(seed)
    branch = "fine" if renderer.using_fine else "coarse"
    # rays sharded over the ranks when there are several
    render = RenderParallel(renderer, model, mesh=parallel.default_mesh())
    z_near, z_far = dset.z_near, dset.z_far
    rng = np.random.default_rng(seed)
    source = np.asarray(source, dtype=np.int64)
    random_source = len(source) == 1 and source[0] == -1
    total_psnr = total_ssim = 0.0
    cnt = 0
    for data in DataLoader(dset, batch_size=batch_size, shuffle=False):
        images = np.asarray(data["images"])  # (SB, NV, 3, H, W)
        poses = np.asarray(data["poses"])
        focals = np.asarray(data["focal"], dtype=np.float32)
        c = np.asarray(data["c"]) if "c" in data else None
        SB, NV, _, H, W = images.shape
        if random_source:
            src = rng.integers(0, NV, size=(SB, 1))
        else:
            if (source < 0).any() or (source >= NV).any():
                raise SystemExit(
                    f"source view(s) {source.tolist()} out of range for "
                    f"dataset with {NV} views (pass -P with valid indices)")
            src = np.broadcast_to(source[None], (SB, len(source))).copy()
        tgt = rng.integers(0, NV, size=(SB,))
        rows = np.arange(SB)[:, None]
        with torch.no_grad():
            cond = model.encode(images[rows, src], poses[rows, src], focals,
                                c=c)
        tgt_poses = poses[np.arange(SB), tgt]  # (SB, 4, 4)
        rays = np.stack([
            camera.gen_rays(
                torch.from_numpy(tgt_poses[b:b + 1]), W, H,
                torch.as_tensor(focals[b]), z_near, z_far,
                c=torch.as_tensor(c[b]) if c is not None else None,
            ).reshape(-1, 8).numpy()
            for b in range(SB)
        ])  # (SB, H*W, 8)
        out = render(cond, rays, generator=gen)[branch]
        rgb = np.clip(out["rgb"].float().cpu().numpy().reshape(SB, H, W, 3),
                      0, 1)
        gt = (images[np.arange(SB), tgt] * 0.5 + 0.5).transpose(0, 2, 3, 1)
        for b in range(SB):
            total_psnr += psnr_fn(rgb[b], gt[b])
            total_ssim += ssim_fn(rgb[b], gt[b], multichannel=True,
                                  data_range=1)
            cnt += 1
        print("curr psnr", total_psnr / cnt, "ssim", total_ssim / cnt)
    return total_psnr / cnt, total_ssim / cnt


def main(argv=None):
    args, conf = parse_args(extra_args, argv=argv)
    return parallel.launch(run, args, conf)


def run(args, conf):
    """The approximate evaluation on one rank."""
    model = load_model(args, conf, args.device)
    dset = get_split_dataset(args.dataset_format, args.datadir,
                             want_split=args.split, training=False)
    renderer = eval_renderer(conf, model, dset, args.ray_batch_size,
                             args.coarse, args.device)
    psnr, ssim = evaluate(model, renderer, dset,
                          list(map(int, args.source.split())),
                          batch_size=args.batch_size, seed=args.seed)
    print("final psnr", psnr, "ssim", ssim)
    return psnr, ssim


if __name__ == "__main__":
    main()
