"""Full NeRF evaluation: renders every target view of every object and
scores PSNR and SSIM.

    python -m pixelnerf_yolo_torch.eval.eval -n <name> -c <conf> \
        -D <data> -F srn -P "64" [-L viewlist] [-O eval] [--device cuda]

Counterpart of the repo's eval/eval.py, with its flags: fixed (-P) or
per-object (-L viewlist) source views, finish.txt resumability, --coarse
(the coarse MLP at 64 + 128 samples), PNG / depth / compare outputs,
--scale with the ground truth resized to match.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .. import parallel
from ..config.args import parse_args
from ..data import DataLoader, get_split_dataset
from ..ops.resize import resize_area, resize_bilinear
from ..render.nerf import NeRFRenderer
from ..utils import camera
from ..utils.metrics import psnr as psnr_fn, ssim as ssim_fn
from ._common import (
    add_device_arg,
    load_model,
    render_rays,
)


def extra_args(parser):
    parser.add_argument("--split", type=str, default="test",
                        help="Split of data to use train | val | test")
    parser.add_argument("--source", "-P", type=str, default="64",
                        help="Source view(s) for each object. Alternatively, "
                        "specify -L to viewlist file and leave this blank.")
    parser.add_argument("--eval_view_list", type=str, default=None,
                        help="Path to eval view list")
    parser.add_argument("--coarse", action="store_true",
                        help="Coarse network as fine")
    parser.add_argument("--no_compare_gt", action="store_true",
                        help="Skip GT comparison and only render images")
    parser.add_argument("--multicat", action="store_true",
                        help="Prepend category id to object id.")
    parser.add_argument("--viewlist", "-L", type=str, default="",
                        help="Path to source view list e.g. src_dvr.txt; "
                        "overrides source/P")
    parser.add_argument("--output", "-O", type=str, default="eval",
                        help="If specified, saves generated images to dir")
    parser.add_argument("--include_src", action="store_true",
                        help="Include source views in calculation")
    parser.add_argument("--scale", type=float, default=1.0,
                        help="Video scale relative to input size")
    parser.add_argument("--write_depth", action="store_true",
                        help="Write depth image")
    parser.add_argument("--write_compare", action="store_true",
                        help="Write GT comparison image")
    parser.add_argument("--free_pose", action="store_true",
                        help="Poses may change between objects")
    parser.add_argument("--seed", type=int, default=0)
    return add_device_arg(parser)


def eval_renderer(conf, model, dset, ray_batch_size: int, coarse: bool,
                  device):
    """The conf's NeRF renderer with eval_batch_size = ray_batch_size and
    at least 64 coarse samples; --coarse drops the fine MLP (in place) and
    renders 64 + 128 samples through the coarse one."""
    renderer = NeRFRenderer.from_conf(
        conf.get_config("renderer"), lindisp=getattr(dset, "lindisp", False),
        eval_batch_size=ray_batch_size, device=device)
    if coarse:
        model.mlp_fine = None
        renderer = dataclasses.replace(renderer, n_coarse=64, n_fine=128)
    if renderer.n_coarse < 64:
        renderer = dataclasses.replace(renderer, n_coarse=64)
    return renderer


def evaluate(model, renderer, dset, source=None, source_lut=None,
             eval_views=None, include_src=False, scale=1.0, free_pose=False,
             multicat=False, compare_gt=True, ray_batch_size=50000, seed=0,
             skip=(), on_object=None):
    """Render each object's target views and score them.

    :param source sorted source views for every object, or source_lut
      {"<category>/<object>": views} (a viewlist)
    :param eval_views None (every view) or the target views
    :param skip object names to pass over (finished earlier)
    :param on_object called as on_object(obj_name, view_idxs, rgb (n, H, W,
      3) in [0, 1], depth (n, H, W) normalized to [near, far] -> [0, 1],
      gt (n, H, W, 3) or None, psnr, ssim) after each object
    :return {"psnr": mean, "ssim": mean, "objects": [(name, psnr, ssim)]}
    """
    device = model.device
    gen = torch.Generator(device=device).manual_seed(seed)
    z_near, z_far = dset.z_near, dset.z_far
    NV = dset[0]["images"].shape[0]
    target_view_mask_init = np.ones(NV, dtype=bool)
    if eval_views is not None:
        target_view_mask_init[:] = False
        target_view_mask_init[np.asarray(eval_views)] = True

    objects = []
    all_rays = None
    loader = DataLoader(dset, batch_size=1, shuffle=False)
    total_objs = len(loader)
    for obj_idx, data in enumerate(loader):
        print("OBJECT", obj_idx, "OF", total_objs, "PROGRESS",
              obj_idx / total_objs * 100.0, "%", data["path"][0])
        dpath = data["path"][0]
        obj_basename = os.path.basename(dpath)
        cat_name = os.path.basename(os.path.dirname(dpath))
        obj_name = (cat_name + "_" + obj_basename if multicat
                    else obj_basename)
        if obj_name in skip:
            print("(skip)")
            continue
        images = np.asarray(data["images"][0])  # (NV, 3, H, W)
        NV, _, H, W = images.shape
        if scale != 1.0:
            H, W = int(H * scale), int(W * scale)

        if all_rays is None or source_lut is not None or free_pose:
            if source_lut is not None:
                source = source_lut[cat_name + "/" + obj_basename]
            src_view_mask = np.zeros(NV, dtype=bool)
            src_view_mask[source] = True
            focal = np.asarray(data["focal"][0], dtype=np.float32)
            c = np.asarray(data["c"][0]) if "c" in data else None
            poses = np.asarray(data["poses"][0])
            target_view_mask = target_view_mask_init.copy()
            if not include_src:
                target_view_mask *= ~src_view_mask
            novel_view_idxs = np.nonzero(target_view_mask)[0]
            all_rays = camera.gen_rays(
                torch.from_numpy(poses[target_view_mask].reshape(-1, 4, 4)),
                W, H, torch.as_tensor(focal * scale), z_near, z_far,
                c=torch.as_tensor(c * scale) if c is not None else None,
            ).reshape(-1, 8).numpy()
            # a (2,) focal is (fx, fy), not two per-view scalars
            focal_b = focal[None]
            c_b = c[None] if c is not None else None

        n_gen_views = len(novel_view_idxs)
        with torch.no_grad():
            cond = model.encode(images[src_view_mask][None],
                                np.asarray(data["poses"][0])[src_view_mask][
                                    None], focal_b, c=c_b)
        rgb, depth = render_rays(renderer, model, cond, all_rays,
                                 ray_batch_size, gen)
        depth = ((depth - z_near) / (z_far - z_near)).reshape(
            n_gen_views, H, W)
        rgb = np.clip(rgb.reshape(n_gen_views, H, W, 3), 0.0, 1.0)

        curr_psnr = curr_ssim = 0.0
        gt = None
        if compare_gt:
            gt_views = images[target_view_mask] * 0.5 + 0.5
            if scale != 1.0 and gt_views.shape[-2:] != (H, W):
                resize = resize_area if scale < 1.0 else resize_bilinear
                gt_views = resize(torch.from_numpy(gt_views), (H, W)).numpy()
            gt = gt_views.transpose(0, 2, 3, 1)
            for i in range(n_gen_views):
                curr_ssim += ssim_fn(rgb[i], gt[i], multichannel=True,
                                     data_range=1)
                curr_psnr += psnr_fn(rgb[i], gt[i])
        curr_psnr /= n_gen_views
        curr_ssim /= n_gen_views
        objects.append((obj_name, curr_psnr, curr_ssim))
        if compare_gt:
            n = len(objects)
            print("curr psnr", curr_psnr, "ssim", curr_ssim,
                  "running psnr", sum(o[1] for o in objects) / n,
                  "running ssim", sum(o[2] for o in objects) / n)
        if on_object is not None:
            on_object(obj_name, novel_view_idxs, rgb, depth, gt, curr_psnr,
                      curr_ssim)
    n = max(len(objects), 1)
    return {"psnr": sum(o[1] for o in objects) / n,
            "ssim": sum(o[2] for o in objects) / n, "objects": objects}


def _write_object(output_dir, args, finish_file):
    """The on_object callback of main: PNGs, depth and compare images,
    and a finish.txt line."""

    def write(obj_name, view_idxs, rgb, depth, gt, psnr, ssim):
        import imageio

        obj_out_dir = os.path.join(output_dir, obj_name)
        os.makedirs(obj_out_dir, exist_ok=True)
        for i, v in enumerate(view_idxs):
            v = int(v)
            imageio.imwrite(os.path.join(obj_out_dir, "{:06}.png".format(v)),
                            (rgb[i] * 255).astype(np.uint8))
            if args.write_depth:
                _write_depth(obj_out_dir, v, depth[i])
            if args.write_compare and gt is not None:
                imageio.imwrite(
                    os.path.join(obj_out_dir, "{:06}_compare.png".format(v)),
                    (np.hstack((rgb[i], gt[i])) * 255).astype(np.uint8))
        finish_file.write("{} {} {} {}\n".format(obj_name, psnr, ssim, 1))

    return write


def _write_depth(obj_out_dir, view: int, depth):
    """The depth as EXR (a raw .npy where cv2 has no OpenEXR codec) and as
    a normalized colour PNG."""
    import imageio

    from ..utils.image import cmap

    exr_path = os.path.join(obj_out_dir, "{:06}_depth.exr".format(view))
    try:
        import cv2

        if not cv2.imwrite(exr_path, depth):
            raise RuntimeError("cv2.imwrite returned False")
    except Exception as e:  # codec missing or cv2 absent
        if not getattr(_write_depth, "warned", False):
            print("EXR unavailable ({}); writing raw .npy depth "
                  "instead".format(e))
            _write_depth.warned = True
        np.save(os.path.splitext(exr_path)[0] + ".npy", depth)
    imageio.imwrite(
        os.path.join(obj_out_dir, "{:06}_depth_norm.png".format(view)),
        cmap(depth))


def main(argv=None):
    args, conf = parse_args(extra_args, default_conf="conf/default_mv.conf",
                            default_expname="shapenet", argv=argv)
    return parallel.launch(run, args, conf)


def run(args, conf):
    """The evaluation on one rank (only rank 0 writes the output)."""
    dset = get_split_dataset(args.dataset_format, args.datadir,
                             want_split=args.split, training=False)

    output_dir = args.output.strip()
    has_output = len(output_dir) > 0
    finished, prev, finish_file = set(), [], None
    if has_output:
        # every rank reads what an earlier run finished; rank 0 writes
        finish_path = os.path.join(output_dir, "finish.txt")
        if os.path.exists(finish_path):
            with open(finish_path, "r") as f:
                prev = [x.strip().split() for x in f.readlines()]
            prev = [x for x in prev if len(x) == 4]
            finished = set(x[0] for x in prev)
            cnt = sum(int(x[3]) for x in prev)
            if cnt > 0:
                print("resume psnr", sum(float(x[1]) for x in prev) / cnt,
                      "ssim", sum(float(x[2]) for x in prev) / cnt)
        if parallel.is_main():
            os.makedirs(output_dir, exist_ok=True)
            finish_file = open(finish_path, "a", buffering=1)
        print("Writing images to", output_dir)

    model = load_model(args, conf, args.device)
    renderer = eval_renderer(conf, model, dset, args.ray_batch_size,
                             args.coarse, args.device)
    source_lut, source = None, None
    if args.viewlist:
        print("Using views from list", args.viewlist)
        with open(args.viewlist, "r") as f:
            rows = [x.strip().split() for x in f.readlines()]
        source_lut = {x[0] + "/" + x[1]: np.array(list(map(int, x[2:])),
                                                  dtype=np.int64)
                      for x in rows}
    else:
        source = np.array(sorted(map(int, args.source.split())),
                          dtype=np.int64)
    eval_views = None
    if args.eval_view_list is not None:
        with open(args.eval_view_list, "r") as f:
            eval_views = np.array(list(map(int, f.readline().split())))

    res = evaluate(
        model, renderer, dset, source=source, source_lut=source_lut,
        eval_views=eval_views, include_src=args.include_src,
        scale=args.scale, free_pose=args.free_pose, multicat=args.multicat,
        compare_gt=not args.no_compare_gt,
        ray_batch_size=args.ray_batch_size, seed=args.seed, skip=finished,
        on_object=(_write_object(output_dir, args, finish_file)
                   if finish_file is not None else None))
    if finish_file is not None:
        finish_file.close()
    objects = [(x[0], float(x[1]), float(x[2])) for x in prev] + res[
        "objects"]
    cnt = len(objects)
    psnr = sum(o[1] for o in objects) / cnt
    ssim = sum(o[2] for o in objects) / cnt
    print("final psnr", psnr, "ssim", ssim)
    return {"psnr": psnr, "ssim": ssim, "objects": objects}


if __name__ == "__main__":
    main()
