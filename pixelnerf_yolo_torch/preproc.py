"""Background removal, cropping and normalization of real photos for
``eval.eval_real`` (the port of scripts/preproc.py).

    python -m pixelnerf_yolo_torch.preproc <images...> [-o input]
        [--size 128] [--seg auto|grabcut|pointrend] [--coco_class 2]
        [--device cuda]

Each photo's object is masked, composited on white, cropped to a padded
square and resized; ``<name>_normalize.png`` is written to the output
directory.  Masks (--seg):
  * pointrend: the port's PointRend R50-FPN (``segment``), the best
    instance of --coco_class (2 = car; -1 = any); needs
    ``pointrend_r50fpn.npz`` on the ``nn.pretrained.search_dirs`` path;
  * grabcut: OpenCV's GrabCut seeded with the central 80% rectangle;
  * auto: pointrend when the npz is found, else grabcut.
Image reading and writing, and GrabCut, need OpenCV (``cv2``); the
predictor itself does not.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "python -m pixelnerf_yolo_torch.preproc needs OpenCV (cv2) to "
            "read and write images and for GrabCut") from e
    return cv2


def segment_grabcut(img: np.ndarray, iters: int = 5) -> np.ndarray:
    """Foreground mask by GrabCut seeded with the central 80% rectangle."""
    cv2 = _cv2()
    h, w = img.shape[:2]
    rect = (int(w * 0.1), int(h * 0.1), int(w * 0.8), int(h * 0.8))
    mask = np.zeros((h, w), np.uint8)
    bgd = np.zeros((1, 65), np.float64)
    fgd = np.zeros((1, 65), np.float64)
    cv2.grabCut(img, mask, rect, bgd, fgd, iters, cv2.GC_INIT_WITH_RECT)
    return ((mask == cv2.GC_FGD) | (mask == cv2.GC_PR_FGD)).astype(np.uint8)


def segment_pointrend(predictor, img: np.ndarray) -> np.ndarray:
    """The best-scoring instance's mask (the predictor filters the class);
    the whole image when nothing is detected."""
    masks = predictor.segment(img)
    if len(masks) == 0:
        print("WARNING: PointRend detected no objects; keeping everything")
        return np.ones(img.shape[:2], np.uint8)
    return (masks[0] > 127).astype(np.uint8)


def normalize_image(img: np.ndarray, mask: np.ndarray, size: int,
                    pad_frac: float = 0.1) -> np.ndarray:
    """White-composite the object, crop to a padded square, resize."""
    cv2 = _cv2()
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        crop = img
    else:
        y0, y1 = ys.min(), ys.max()
        x0, x1 = xs.min(), xs.max()
        side = int(max(y1 - y0, x1 - x0) * (1 + 2 * pad_frac))
        cy, cx = (y0 + y1) // 2, (x0 + x1) // 2
        half = side // 2
        comp = np.full_like(img, 255)
        m3 = mask[..., None].astype(bool)
        np.copyto(comp, img, where=np.broadcast_to(m3, img.shape))
        # pad the composite so that the crop never leaves the image
        comp = cv2.copyMakeBorder(comp, half, half, half, half,
                                  cv2.BORDER_CONSTANT, value=(255, 255, 255))
        crop = comp[cy:cy + 2 * half, cx:cx + 2 * half]
    return cv2.resize(crop, (size, size), interpolation=cv2.INTER_AREA)


def main(argv=None, predictor=None) -> list[str]:
    """Run the tool; returns the paths written.  ``predictor`` replaces
    the PointRend predictor built from the npz (--seg pointrend)."""
    parser = argparse.ArgumentParser(prog="python -m pixelnerf_yolo_torch.preproc")
    parser.add_argument("images", nargs="+", help="input image paths")
    parser.add_argument("-o", "--output", default="input",
                        help="output directory")
    parser.add_argument("--size", type=int, default=128,
                        help="output square size")
    parser.add_argument("--seg", choices=["auto", "grabcut", "pointrend"],
                        default="auto")
    parser.add_argument("--coco_class", type=int, default=2,
                        help="COCO class wanted (0 = human, 2 = car; "
                        "-1 = any), pointrend only")
    parser.add_argument("--device", default="cuda",
                        help="device of the PointRend predictor")
    args = parser.parse_args(argv)
    cv2 = _cv2()
    from .segment import PointRendPredictor, pointrend_npz_path

    os.makedirs(args.output, exist_ok=True)
    seg_kind = args.seg
    if seg_kind == "auto":
        seg_kind = ("pointrend" if predictor is not None
                    or pointrend_npz_path() else "grabcut")
        print(f"--seg auto -> {seg_kind}")
    if seg_kind == "pointrend":
        predictor = predictor or PointRendPredictor(
            filter_class=args.coco_class, device=args.device)

        def seg(img):
            return segment_pointrend(predictor, img)
    else:
        seg = segment_grabcut
    written = []
    for path in args.images:
        img = cv2.imread(path)
        if img is None:
            print("skip unreadable", path)
            continue
        out = normalize_image(img, seg(img), args.size)
        base = os.path.splitext(os.path.basename(path))[0]
        out_path = os.path.join(args.output, base + "_normalize.png")
        cv2.imwrite(out_path, out)
        print("wrote", out_path)
        written.append(out_path)
    return written


if __name__ == "__main__":
    main()
