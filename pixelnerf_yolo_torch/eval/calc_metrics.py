"""Quality metrics over rendered output directories (eval's -O output),
map then reduce: each object's metrics.txt (psnr, ssim and, where LPIPS is
available, lpips) against the dataset's ground truth, then all_metrics.txt
with per-category means under --multicat.

    python -m pixelnerf_yolo_torch.eval.calc_metrics -D <data> -O eval \
        -F dvr [--device cuda]

Counterpart of the repo's eval/calc_metrics.py, with its flags.  LPIPS
(VGG16) comes from nn/lpips.py with lpips_vgg.npz, else from the ``lpips``
package where it imports, else it is skipped (and reported as 0.0).
"""

from __future__ import annotations

import argparse
import glob
import os.path as osp

import numpy as np
import torch

from ..utils.metrics import psnr as psnr_fn, ssim as ssim_fn

# DTU views the reference excludes with --exclude_dtu_bad
DTU_BAD_VIEWS = [3, 4, 5, 6, 7, 16, 17, 18, 19, 20, 21, 36, 37, 38, 39]


def make_parser():
    parser = argparse.ArgumentParser(
        description="Calculate PSNR for rendered images.")
    parser.add_argument("--datadir", "-D", type=str, required=True,
                        help="Dataset directory (used directly)")
    parser.add_argument("--output", "-O", type=str, default="eval",
                        help="Root path of rendered output (from eval)")
    parser.add_argument("--dataset_format", "-F", type=str, default="dvr",
                        help="Dataset format, nerf | srn | dvr")
    parser.add_argument("--list_name", type=str, default="softras_test",
                        help="Filter list prefix for DVR")
    parser.add_argument("--gpu_id", type=str, default="0",
                        help="device(s), space delimited; the metrics are "
                        "computed on the host, so a list changes nothing")
    parser.add_argument("--overwrite", action="store_true",
                        help="overwrite existing metrics.txt")
    parser.add_argument("--exclude_dtu_bad", action="store_true",
                        help="exclude hardcoded DTU bad views")
    parser.add_argument("--multicat", action="store_true",
                        help="Prepend category id to object id.")
    parser.add_argument("--viewlist", "-L", type=str, default="",
                        help="Source view list; excludes sources from eval")
    parser.add_argument("--eval_view_list", type=str, default=None)
    parser.add_argument("--primary", "-P", type=str, default="",
                        help="List of views to exclude")
    parser.add_argument("--lpips_batch_size", type=int, default=32)
    parser.add_argument("--reduce_only", "-R", action="store_true",
                        help="skip the map (per-obj metric computation)")
    parser.add_argument("--metadata", type=str, default="metadata.yaml")
    parser.add_argument("--dtu_sort", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of LPIPS (cuda or cpu)")
    return parser


def make_lpips(device):
    """(lpips_fn(rgb, gt) on (H, W, 3) images in [0, 1], or None): the
    native VGG16 with lpips_vgg.npz, else the ``lpips`` package, else None
    (after printing why)."""
    from ..nn.lpips import load_lpips, lpips_distance

    def as_input(img):
        x = torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1)))
        return x[None].float() * 2 - 1

    try:
        params, path = load_lpips(device)
    except FileNotFoundError as e:
        native_err = str(e)
    else:
        print("LPIPS: native vgg,", path)

        def lpips_fn(rgb, gt):
            with torch.no_grad():
                return float(lpips_distance(params, as_input(rgb).to(device),
                                            as_input(gt).to(device))[0])

        return lpips_fn
    try:
        import lpips as lpips_pkg

        # its VGG16 weights come from torchvision's cache or download
        model = lpips_pkg.LPIPS(net="vgg").to(device)
    except (ImportError, OSError) as e:
        print("LPIPS unavailable (reported as 0.0):", native_err,
              f"({type(e).__name__}: {e})")
        return None

    def package_fn(rgb, gt):
        with torch.no_grad():
            return float(model(as_input(rgb).to(device),
                               as_input(gt).to(device)))

    return package_fn


def object_metrics(pairs, lpips_fn=None) -> dict:
    """Mean psnr, ssim (and lpips) over (rendered, ground truth) pairs of
    (H, W, 3) images in [0, 1]."""
    n_psnr = n_ssim = n_lpips = 0.0
    cnt = 0
    for rgb, gt in pairs:
        n_psnr += psnr_fn(rgb, gt)
        n_ssim += ssim_fn(rgb, gt, multichannel=True, data_range=1)
        if lpips_fn is not None:
            n_lpips += lpips_fn(rgb.astype(np.float32), gt.astype(np.float32))
        cnt += 1
    if cnt == 0:
        return {}
    out = {"psnr": n_psnr / cnt, "ssim": n_ssim / cnt}
    if lpips_fn is not None:
        out["lpips"] = n_lpips / cnt
    return out


def iter_objects(args, img_dir_name):
    """(obj_name, gt_img_dir, rendered_dir) of each rendered object."""
    for rend_dir in sorted(glob.glob(osp.join(args.output, "*"))):
        if not osp.isdir(rend_dir):
            continue
        obj_name = osp.basename(rend_dir)
        if args.multicat:
            cat, obj = obj_name.split("_", 1)
            gt_dir = osp.join(args.datadir, cat, obj, img_dir_name)
        else:
            gt_dir = None
            for cand in glob.glob(osp.join(args.datadir, "*")):
                p = osp.join(cand, obj_name, img_dir_name)
                if osp.isdir(p):
                    gt_dir = p
                    break
            if gt_dir is None:
                p = osp.join(args.datadir, obj_name, img_dir_name)
                if osp.isdir(p):
                    gt_dir = p
        if gt_dir is None or not osp.isdir(gt_dir):
            print("WARNING: no GT found for", obj_name)
            continue
        yield obj_name, gt_dir, rend_dir


def _pairs(args, gt_dir, rend_dir):
    """(rendered, ground truth) images of one object, the ground truth
    resized to the rendered size where they differ."""
    import imageio.v2 as imageio

    primary_excl = (set(map(int, args.primary.split())) if args.primary
                    else set())
    gt_paths = sorted(p for p in glob.glob(osp.join(gt_dir, "*"))
                      if p.endswith((".png", ".jpg")))
    for rend_path in sorted(glob.glob(osp.join(rend_dir, "*.png"))):
        base = osp.basename(rend_path)
        if not base[:6].isdigit() or "_" in base:  # depth/compare variants
            continue
        view_idx = int(base[:6])
        if view_idx in primary_excl:
            continue
        if args.exclude_dtu_bad and view_idx in DTU_BAD_VIEWS:
            continue
        if view_idx >= len(gt_paths):
            continue
        rgb = imageio.imread(rend_path)[..., :3] / 255.0
        gt = imageio.imread(gt_paths[view_idx])[..., :3] / 255.0
        if rgb.shape != gt.shape:
            import cv2

            gt = cv2.resize(gt, (rgb.shape[1], rgb.shape[0]),
                            interpolation=cv2.INTER_AREA)
        yield rgb, gt


def run_map(args, img_dir_name, lpips_fn):
    for obj_name, gt_dir, rend_dir in iter_objects(args, img_dir_name):
        out_path = osp.join(rend_dir, "metrics.txt")
        if osp.exists(out_path) and not args.overwrite:
            continue
        m = object_metrics(_pairs(args, gt_dir, rend_dir), lpips_fn)
        if not m:
            continue
        with open(out_path, "w") as f:
            for k, v in m.items():
                f.write("{} {}\n".format(k, v))
        print(obj_name, "psnr", m["psnr"], "ssim", m["ssim"])


def run_reduce(args, img_dir_name, has_lpips):
    out_metrics_path = osp.join(args.output, "all_metrics.txt")
    sums: dict = {}
    cat_sums: dict = {}
    counts: dict = {}
    total = 0
    for obj_name, _gt, rend_dir in iter_objects(args, img_dir_name):
        metrics_path = osp.join(rend_dir, "metrics.txt")
        if not osp.exists(metrics_path):
            continue
        cat = obj_name.split("_", 1)[0] if args.multicat else "all"
        with open(metrics_path, "r") as f:
            for line in f:
                name, val = line.strip().split()
                sums[name] = sums.get(name, 0.0) + float(val)
                key = cat + "." + name
                cat_sums[key] = cat_sums.get(key, 0.0) + float(val)
        counts[cat] = counts.get(cat, 0) + 1
        total += 1
    if total == 0:
        print("No per-object metrics found; run the map phase first")
        return {}
    lines = ["{} {}".format(name, val / total)
             for name, val in sorted(sums.items())]
    if args.multicat:
        for key, val in sorted(cat_sums.items()):
            lines.append("{} {}".format(key, val / counts[key.split(".")[0]]))
    text = "\n".join(lines)
    with open(out_metrics_path, "w") as f:
        f.write(text + "\n")
    if not has_lpips:
        print("(lpips unavailable in this environment; skipped)")
    print(text)
    print("Wrote", out_metrics_path)
    return {name: val / total for name, val in sums.items()}


def main(argv=None):
    args = make_parser().parse_args(argv)
    if args.dataset_format == "dvr":
        img_dir_name = "image"
    elif args.dataset_format == "srn":
        img_dir_name = "rgb"
    else:
        raise NotImplementedError(
            "Not supported data format " + args.dataset_format)
    lpips_fn = make_lpips(args.device)
    if not args.reduce_only:
        run_map(args, img_dir_name, lpips_fn)
    return run_reduce(args, img_dir_name, lpips_fn is not None)


if __name__ == "__main__":
    main()
