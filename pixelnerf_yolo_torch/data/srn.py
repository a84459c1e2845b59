"""SRN ShapeNet dataset (cars/chairs).

Counterpart of pixelnerf_yolo_tpu/data/srn.py.  Pure numpy; yields dicts
of float32 arrays (images CHW in [-1, 1]).  imageio is an optional
import: reading a scene without it raises.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from .base import (
    area_resize_chw,
    image_to_tensor_balanced,
    imageio,
    mask_bbox,
    mask_to_tensor,
)


class SRNDataset:
    def __init__(
        self, path, stage="train", image_size=(128, 128), world_scale=1.0,
        conf=None,
    ):
        self.base_path = path + "_" + stage
        self.dataset_name = os.path.basename(path)
        print("Loading SRN dataset", self.base_path, "name:", self.dataset_name)
        self.stage = stage
        assert os.path.exists(self.base_path)

        is_chair = "chair" in self.dataset_name
        if is_chair and stage == "train":
            # the public SRN chairs train split sits one directory deeper
            tmp = os.path.join(self.base_path, "chairs_2.0_train")
            if os.path.exists(tmp):
                self.base_path = tmp

        self.intrins = sorted(
            glob.glob(os.path.join(self.base_path, "*", "intrinsics.txt"))
        )
        self.image_to_tensor = image_to_tensor_balanced
        self.image_size = tuple(image_size)
        self.world_scale = world_scale
        # camera coord flip diag(1,-1,-1,1)
        self._coord_trans = np.diag(
            np.array([1, -1, -1, 1], dtype=np.float32)
        )

        if is_chair:
            self.z_near, self.z_far = 1.25, 2.75
        else:
            self.z_near, self.z_far = 0.8, 1.8
        self.lindisp = False

    def __len__(self):
        return len(self.intrins)

    def __getitem__(self, index):
        intrin_path = self.intrins[index]
        dir_path = os.path.dirname(intrin_path)
        rgb_paths = sorted(glob.glob(os.path.join(dir_path, "rgb", "*")))
        pose_paths = sorted(glob.glob(os.path.join(dir_path, "pose", "*")))
        assert len(rgb_paths) == len(pose_paths)
        if imageio is None:
            raise ImportError("reading an SRN scene needs imageio")

        with open(intrin_path, "r") as f:
            lines = f.readlines()
            focal, cx, cy, _ = map(float, lines[0].split())

        all_imgs, all_poses, all_masks, all_bboxes = [], [], [], []
        for rgb_path, pose_path in zip(rgb_paths, pose_paths):
            img = imageio.imread(rgb_path)[..., :3]
            img_tensor = self.image_to_tensor(img)
            mask = (img != 255).all(axis=-1)[..., None].astype(np.uint8) * 255
            all_masks.append(mask_to_tensor(mask))
            pose = np.loadtxt(pose_path, dtype=np.float32).reshape(4, 4)
            all_poses.append(pose @ self._coord_trans)
            all_bboxes.append(mask_bbox(mask, rgb_path))
            all_imgs.append(img_tensor)

        all_imgs = np.stack(all_imgs)
        all_poses = np.stack(all_poses)
        all_masks = np.stack(all_masks)
        all_bboxes = np.stack(all_bboxes)

        if all_imgs.shape[-2:] != self.image_size:
            scale = self.image_size[0] / all_imgs.shape[-2]
            focal *= scale
            cx *= scale
            cy *= scale
            all_bboxes = all_bboxes * scale
            all_imgs = area_resize_chw(all_imgs, self.image_size)
            all_masks = area_resize_chw(all_masks, self.image_size)

        if self.world_scale != 1.0:
            focal *= self.world_scale
            all_poses[:, :3, 3] *= self.world_scale

        return {
            "path": dir_path,
            "img_id": index,
            "focal": np.float32(focal),
            "c": np.array([cx, cy], dtype=np.float32),
            "images": all_imgs,
            "masks": all_masks,
            "bbox": all_bboxes,
            "poses": all_poses,
        }
