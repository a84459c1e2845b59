"""Blender-rendered multi-object ShapeNet scenes.

Counterpart of pixelnerf_yolo_tpu/data/multi_object.py.  imageio is an
optional import: reading a scene without it raises.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from .base import image_to_tensor_balanced, imageio, mask_to_tensor


class MultiObjectDataset:
    def __init__(self, path, stage="train", z_near=4, z_far=9, n_views=None,
                 conf=None):
        path = os.path.join(path, stage)
        self.base_path = path
        print("Loading NeRF synthetic dataset", self.base_path)
        trans_files = []
        for root, _dirs, filenames in os.walk(self.base_path):
            if "transforms.json" in filenames:
                trans_files.append(os.path.join(root, "transforms.json"))
        self.trans_files = trans_files
        self.image_to_tensor = image_to_tensor_balanced
        self.z_near = z_near
        self.z_far = z_far
        self.lindisp = False
        self.n_views = n_views
        print("{} instances in split {}".format(len(self.trans_files), stage))

    def __len__(self):
        return len(self.trans_files)

    def _check_valid(self, index):
        if self.n_views is None:
            return True
        trans_file = self.trans_files[index]
        dir_path = os.path.dirname(trans_file)
        try:
            with open(trans_file, "r") as f:
                transform = json.load(f)
        except Exception as e:
            print("Problematic transforms.json file", trans_file)
            print("JSON loading exception", e)
            return False
        if len(transform["frames"]) != self.n_views:
            return False
        if len(glob.glob(os.path.join(dir_path, "*.png"))) != self.n_views:
            return False
        return True

    def __getitem__(self, index):
        if not self._check_valid(index):
            return {}

        if imageio is None:
            raise ImportError("reading a multi-object scene needs imageio")
        trans_file = self.trans_files[index]
        dir_path = os.path.dirname(trans_file)
        with open(trans_file, "r") as f:
            transform = json.load(f)

        all_imgs, all_bboxes, all_masks, all_poses = [], [], [], []
        for frame in transform["frames"]:
            fpath = frame["file_path"]
            basename = os.path.splitext(os.path.basename(fpath))[0]
            obj_path = os.path.join(dir_path, "{}_obj.png".format(basename))
            img = imageio.imread(obj_path)
            mask = mask_to_tensor(img[..., 3])  # alpha channel (1, H, W)
            # bbox over the raw rgba-any-channel mask
            rows = np.any(img, axis=1)
            cols = np.any(img, axis=0)
            rnz = np.where(rows)[0]
            cnz = np.where(cols)[0]
            if len(rnz) == 0:
                cmin = rmin = 0
                cmax = mask.shape[-1]
                rmax = mask.shape[-2]
            else:
                rmin, rmax = rnz[[0, -1]]
                cmin, cmax = cnz[[0, -1]]
            all_bboxes.append(
                np.array([cmin, rmin, cmax, rmax], dtype=np.float32)
            )

            img_tensor = self.image_to_tensor(img[..., :3])
            # composite onto white where transparent
            img_tensor = img_tensor * mask + (1.0 - mask)
            all_imgs.append(img_tensor)
            all_masks.append(mask)
            all_poses.append(
                np.asarray(frame["transform_matrix"], dtype=np.float32)
            )

        imgs = np.stack(all_imgs)
        masks = np.stack(all_masks)
        bboxes = np.stack(all_bboxes)
        poses = np.stack(all_poses)

        H, W = imgs.shape[-2:]
        camera_angle_x = transform.get("camera_angle_x")
        focal = 0.5 * W / np.tan(0.5 * camera_angle_x)

        return {
            "path": dir_path,
            "img_id": index,
            "focal": np.float32(focal),
            "images": imgs,
            "masks": masks,
            "bbox": bboxes,
            "poses": poses,
        }
