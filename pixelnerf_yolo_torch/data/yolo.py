"""YOLO novel-view detection dataset.

Counterpart of pixelnerf_yolo_tpu/data/yolo.py.  Per-scene dirs of
image_%04d.png + extrinsic_%04d.npy + intrinsic_0000.npy +
projected_bboxes_%04d.txt; split lists train/val/test.lst at the root.

Quirks kept: pose X-row negation, image rescale by yolo.image_scale,
per-scale grid-target assignment with best-anchor selection and ignore
flag -1 above ignore_iou_thresh (``_get_all_bboxes``, which a dataset
held in memory can call after ``set_target_conf``).  imageio and cv2 are
optional imports: reading a scene without them raises (a resize is never
skipped); ``_get_all_bboxes`` needs neither.
"""

from __future__ import annotations

import os

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

from ..detect.boxes import iou
from .base import image_to_tensor_balanced, imageio


class YOLODataset:
    def __init__(
        self,
        path,
        stage="train",
        z_near=1.2,
        z_far=4.0,
        conf=None,
    ):
        self.base_path = path
        assert os.path.exists(self.base_path)

        file_list = os.path.join(self.base_path, stage + ".lst")
        with open(file_list, "r") as f:
            self.all_objs = [x.strip() for x in f.readlines()]
        self.stage = stage
        self.image_to_tensor = image_to_tensor_balanced
        print(
            "Loading YOLO dataset", self.base_path, "stage", stage,
            len(self.all_objs), "objs",
        )

        self.image_scale = conf["yolo.image_scale"]
        self.z_near = z_near
        self.z_far = z_far
        self.lindisp = False
        self.set_target_conf(conf)

    def set_target_conf(self, conf):
        """The conf values ``_get_all_bboxes`` reads: scales, anchors and
        the ignore threshold."""
        self.num_scales = conf["model.mlp_coarse.num_scales"]
        self.num_anchors_per_scale = conf[
            "model.mlp_coarse.num_anchors_per_scale"
        ]
        self.cell_sizes = conf["yolo.cell_sizes"][: self.num_scales]
        anchors = conf["yolo.anchors"][: self.num_scales]
        self.anchors = np.array(
            [item for sublist in anchors for item in sublist], dtype=np.float32
        )
        self.ignore_iou_thresh = conf["yolo.ignore_iou_thresh"]

    def __len__(self):
        return len(self.all_objs)

    def __getitem__(self, index):
        root_dir = os.path.join(self.base_path, self.all_objs[index])
        all_imgs, all_poses, all_bboxes = [], [], []

        img_count = 0
        while True:
            img_path = os.path.join(
                root_dir, "image_{:04d}.png".format(img_count)
            )
            if not os.path.exists(img_path):
                break
            if imageio is None or cv2 is None:
                raise ImportError("reading a YOLO scene needs imageio and "
                                  "cv2")
            img = imageio.imread(img_path)[..., :3]
            img = cv2.resize(
                img, (0, 0), fx=self.image_scale[0], fy=self.image_scale[1]
            )
            all_imgs.append(self.image_to_tensor(img))
            img_count += 1

        for i in range(img_count):
            pose = np.load(
                os.path.join(root_dir, "extrinsic_{:04d}.npy".format(i))
            ).astype(np.float32)
            pose[0] = pose[0] * -1  # the reference negates the X row
            all_poses.append(pose)

        for i in range(img_count):
            # file rows: cls, cx, cy, w, h -> rolled to cx, cy, w, h, cls
            bboxes = np.roll(
                np.loadtxt(
                    fname=os.path.join(
                        root_dir, "projected_bboxes_{:04d}.txt".format(i)
                    ),
                    delimiter=" ",
                    ndmin=2,
                ),
                4,
                axis=1,
            ).tolist()
            all_bboxes.append(
                self._get_all_bboxes(
                    bboxes, all_imgs[i].shape[1], all_imgs[i].shape[2]
                )
            )

        intrinsic = np.load(os.path.join(root_dir, "intrinsic_0000.npy"))
        focal = (intrinsic[0, 0] * np.array(self.image_scale)).astype(
            np.float32
        )
        c = (intrinsic[:2, 2] * np.array(self.image_scale)).astype(np.float32)

        return {
            "path": root_dir,
            "img_id": index,
            "focal": focal,
            "images": np.stack(all_imgs),
            "bboxes": all_bboxes,  # per view: tuple of per-scale targets
            "poses": np.stack(all_poses),
            "c": c,
        }

    def _get_all_bboxes(self, bboxes, height, width):
        """Build per-scale grid targets (s_h, s_w, A, 6=[prob,x,y,w,h,cls]).

        Best-anchor assignment by wh-IoU, one anchor per scale per box,
        ignore flag -1 for unassigned anchors whose IoU exceeds
        ignore_iou_thresh.
        """
        grid_sizes = [(height // cs, width // cs) for cs in self.cell_sizes]
        targets = [
            np.zeros((s_h, s_w, self.num_anchors_per_scale, 6), dtype=np.float32)
            for (s_h, s_w) in grid_sizes
        ]

        for box in bboxes:
            iou_anchors = iou(
                np.asarray(box[2:4], dtype=np.float32),
                self.anchors,
                is_pred=False,
            )
            anchor_indices = np.argsort(-iou_anchors, kind="stable", axis=0)
            x, y, box_width, box_height, class_label = box

            has_anchor = [False] * self.num_scales
            for anchor_idx in anchor_indices:
                scale_idx = int(anchor_idx) // self.num_anchors_per_scale
                anchor_on_scale = int(anchor_idx) % self.num_anchors_per_scale
                s_h, s_w = grid_sizes[scale_idx]
                i, j = int(s_h * y), int(s_w * x)
                if not (0 <= i < s_h and 0 <= j < s_w):
                    raise IndexError(
                        f"bbox center ({x}, {y}) outside grid {s_h}x{s_w}"
                    )
                anchor_taken = targets[scale_idx][i, j, anchor_on_scale, 0]

                if not anchor_taken and not has_anchor[scale_idx]:
                    targets[scale_idx][i, j, anchor_on_scale, 0] = 1
                    x_cell, y_cell = s_w * x - j, s_h * y - i
                    width_cell = box_width * s_w
                    height_cell = box_height * s_h
                    targets[scale_idx][i, j, anchor_on_scale, 1:5] = [
                        x_cell, y_cell, width_cell, height_cell,
                    ]
                    targets[scale_idx][i, j, anchor_on_scale, 5] = int(
                        class_label
                    )
                    has_anchor[scale_idx] = True
                elif (
                    not anchor_taken
                    and iou_anchors[anchor_idx] > self.ignore_iou_thresh
                ):
                    targets[scale_idx][i, j, anchor_on_scale, 0] = -1

        return tuple(targets)
