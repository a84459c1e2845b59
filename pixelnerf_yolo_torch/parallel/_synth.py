"""The dry run's on-disk YOLO dataset: a copy of the repo's test writer
(tests/synth_data.py ``make_yolo_dataset``, its fixed two-box layout), so
that ``parallel.dryrun`` needs nothing outside the package.  Images are
written with ``utils.image.write_png``; the pixels, poses, intrinsics,
boxes and split lists are the test writer's for the same arguments."""

from __future__ import annotations

import os

import numpy as np

from ..utils.image import write_png

# (class, cx, cy, w, h, colour) in image fractions
BOXES = ((0, 0.5, 0.5, 0.25, 0.3, (250, 60, 60)),
         (1, 0.3, 0.6, 0.1, 0.12, (60, 220, 80)))


def _look_at(origin, target=np.zeros(3), up=np.array([0, 1, 0.0])):
    back = origin - target
    back = back / np.linalg.norm(back)
    right = np.cross(up, back)
    right = right / np.linalg.norm(right)
    upv = np.cross(back, right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, upv, back, origin
    return c2w


def make_yolo_dataset(root, n_scenes=2, n_views=4, img_size=64, seed=0):
    """YOLO-format dataset under root: per scene image_%04d.png,
    extrinsic_%04d.npy, intrinsic_0000.npy, projected_bboxes_%04d.txt;
    train.lst (every scene), val.lst and test.lst (the first).  Returns
    root."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    names = []
    K = np.array([[float(img_size), 0, img_size / 2],
                  [0, float(img_size), img_size / 2],
                  [0, 0, 1]], dtype=np.float64)
    for s in range(n_scenes):
        name = f"scene_{s:03d}"
        names.append(name)
        sdir = os.path.join(root, name)
        os.makedirs(sdir, exist_ok=True)
        np.save(os.path.join(sdir, "intrinsic_0000.npy"), K)
        for v in range(n_views):
            theta = 2 * np.pi * v / n_views
            origin = np.array([7 * np.sin(theta), 1.0, 7 * np.cos(theta)],
                              dtype=np.float32)
            ext = np.linalg.inv(_look_at(origin)).astype(np.float64)
            # the loader negates row 0: store the negated form
            ext[0] = -ext[0]
            np.save(os.path.join(sdir, f"extrinsic_{v:04d}.npy"), ext)
            img = rng.integers(0, 255, size=(img_size, img_size, 3),
                               dtype=np.uint8)
            for _, cx, cy, bw, bh, color in BOXES:
                img[int((cy - bh / 2) * img_size):int((cy + bh / 2)
                                                      * img_size),
                    int((cx - bw / 2) * img_size):int((cx + bw / 2)
                                                      * img_size)] = color
            write_png(os.path.join(sdir, f"image_{v:04d}.png"), img)
            with open(os.path.join(sdir, f"projected_bboxes_{v:04d}.txt"),
                      "w") as f:
                for cls, cx, cy, bw, bh, _ in BOXES:
                    f.write(f"{cls} {cx} {cy} {bw} {bh}\n")
    for split, scenes in (("train", names), ("val", names[:1]),
                          ("test", names[:1])):
        with open(os.path.join(root, f"{split}.lst"), "w") as f:
            f.write("\n".join(scenes) + "\n")
    return root
