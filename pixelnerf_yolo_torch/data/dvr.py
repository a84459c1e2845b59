"""DVR/NMR ShapeNet and DTU dataset.

Counterpart of pixelnerf_yolo_tpu/data/dvr.py: split lists per category,
cameras.npz handling (ShapeNet world_mat_inv; DTU projection
decomposition and scale_mat normalization), per-subformat coordinate
transforms, focal averaging for DTU.  The per-view loop only decodes
images and masks; every camera quantity is computed afterwards on the
stacked ``(V, ...)`` arrays (one batched QR decomposes every DTU
projection, one ``np.linalg.inv`` inverts the ShapeNet extrinsics that
lack a stored inverse, one einsum applies both coordinate transforms).
imageio and cv2 are optional imports: reading a scene without imageio
raises; without cv2 the projections decompose in numpy.
"""

from __future__ import annotations

import glob
import os

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

from .base import (
    area_resize_chw,
    image_to_tensor_balanced,
    imageio,
    mask_bbox,
    mask_to_tensor,
)

_FLIP3 = np.flipud(np.eye(3)).astype(np.float64)


def decompose_projection_batch(P: np.ndarray):
    """Decompose a stack of projection matrices ``P (V, 3, 4)`` into
    intrinsics ``K (V, 3, 3)``, rotations ``R (V, 3, 3)`` and homogeneous
    camera centers ``t (V, 4, 1)``.

    Same K/R/t convention as ``cv2.decomposeProjectionMatrix`` (RQ of the
    left 3x3 via a flipped QR, K diagonal forced positive), but batched:
    one LAPACK call decomposes every view.
    """
    P = np.asarray(P, dtype=np.float64)
    M = P[..., :3]                                   # (V, 3, 3)
    A = _FLIP3 @ M                                   # flip rows
    Q, R_ = np.linalg.qr(np.swapaxes(A, -1, -2))     # batched QR
    K = _FLIP3 @ np.swapaxes(R_, -1, -2) @ _FLIP3
    R = _FLIP3 @ np.swapaxes(Q, -1, -2)
    # Force K's diagonal positive (column signs of K, row signs of R).
    s = np.sign(np.diagonal(K, axis1=-2, axis2=-1))  # (V, 3)
    K = K * s[..., None, :]
    R = R * s[..., :, None]
    c = -np.linalg.solve(M, P[..., 3:])[..., 0]      # camera centers (V, 3)
    t = np.concatenate(
        [c, np.ones((*c.shape[:-1], 1))], axis=-1
    )[..., None]                                     # (V, 4, 1)
    return K, R, t


def decompose_projection(P: np.ndarray):
    """Single-view ``cv2.decomposeProjectionMatrix`` equivalent:
    ``P (3, 4) -> K, R, t`` (t a homogeneous 4-vector column).

    Uses cv2 when importable; otherwise the batched numpy path above.
    """
    if cv2 is not None:
        K, R, t = cv2.decomposeProjectionMatrix(P)[:3]
        return K, R, t
    K, R, t = decompose_projection_batch(P[None])
    return K[0], R[0], t[0]


def _load_object_list(path, list_prefix, stage):
    """(category, object_dir) pairs from every ``<cat>/<prefix><stage>.lst``."""
    cats = [x for x in glob.glob(os.path.join(path, "*")) if os.path.isdir(x)]
    all_objs = []
    for cat_dir in cats:
        file_list = os.path.join(cat_dir, list_prefix + stage + ".lst")
        if not os.path.exists(file_list):
            continue
        cat = os.path.basename(cat_dir)
        with open(file_list, "r") as f:
            all_objs.extend(
                (cat, os.path.join(cat_dir, line.strip())) for line in f
            )
    return all_objs


class DVRDataset:
    def __init__(
        self,
        path,
        stage="train",
        list_prefix="softras_",
        image_size=None,
        sub_format="shapenet",
        scale_focal=True,
        max_imgs=100000,
        z_near=1.2,
        z_far=4.0,
        skip_step=None,
        conf=None,
        rng=None,
    ):
        self.base_path = path
        assert os.path.exists(self.base_path)

        self.all_objs = _load_object_list(path, list_prefix, stage)
        self.stage = stage
        self.image_to_tensor = image_to_tensor_balanced
        print(
            "Loading DVR dataset", self.base_path, "stage", stage,
            len(self.all_objs), "objs", "type:", sub_format,
        )

        self.image_size = image_size
        if sub_format == "dtu":
            # World AND camera flips are the same diag for DTU
            self._coord_trans_world = np.diag(
                np.array([1, -1, -1, 1], dtype=np.float32)
            )
        else:
            self._coord_trans_world = np.array(
                [[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
                dtype=np.float32,
            )
        self._coord_trans_cam = np.diag(
            np.array([1, -1, -1, 1], dtype=np.float32)
        )
        self.sub_format = sub_format
        self.scale_focal = scale_focal
        self.max_imgs = max_imgs
        self.z_near = z_near
        self.z_far = z_far
        self.lindisp = False
        self._rng = rng if rng is not None else np.random.default_rng()

    def __len__(self):
        return len(self.all_objs)

    # ------------------------------------------------------------------
    # Per-object loading, split into I/O and batched camera math.
    # ------------------------------------------------------------------

    def _select_views(self, root_dir):
        rgb_paths = sorted(
            x
            for x in glob.glob(os.path.join(root_dir, "image", "*"))
            if x.endswith((".jpg", ".png"))
        )
        mask_paths = sorted(glob.glob(os.path.join(root_dir, "mask", "*.png")))
        if len(mask_paths) == 0:
            mask_paths = [None] * len(rgb_paths)
        if len(rgb_paths) <= self.max_imgs:
            sel = np.arange(len(rgb_paths))
        else:
            sel = self._rng.choice(len(rgb_paths), self.max_imgs, replace=False)
            rgb_paths = [rgb_paths[i] for i in sel]
            mask_paths = [mask_paths[i] for i in sel]
        return rgb_paths, mask_paths, sel

    def _read_images(self, rgb_paths, mask_paths, want_bboxes):
        """The only per-view loop: decode images/masks off disk."""
        if imageio is None:
            raise ImportError("reading a DVR scene needs imageio")
        imgs, masks, bboxes = [], [], []
        widths, heights = [], []
        for rgb_path, mask_path in zip(rgb_paths, mask_paths):
            img = imageio.imread(rgb_path)[..., :3]
            heights.append(img.shape[0])
            widths.append(img.shape[1])
            imgs.append(self.image_to_tensor(img))
            if mask_path is not None:
                mask = imageio.imread(mask_path)
                if mask.ndim == 2:
                    mask = mask[..., None]
                mask = mask[..., :1]
                masks.append(mask_to_tensor(mask))
                if want_bboxes:
                    bboxes.append(mask_bbox(mask, rgb_path))
        return imgs, masks, bboxes, np.asarray(widths), np.asarray(heights)

    def _cameras_dtu(self, cams, sel, x_scale, y_scale, xy_delta):
        """All-view DTU cameras in one batch: decompose V projection
        matrices at once, normalize by scale_mat where present, average
        the intrinsics."""
        V = len(sel)
        P = np.stack([cams["world_mat_" + str(i)][:3] for i in sel])
        K, R, t = decompose_projection_batch(P)
        K = K / K[:, 2:3, 2:3]

        poses = np.broadcast_to(np.eye(4), (V, 4, 4)).copy()
        poses[:, :3, :3] = np.swapaxes(R, -1, -2)
        centers = t[:, :3, 0] / t[:, 3:, 0]          # (V, 3)

        # scale_mat normalization: t' = (t - trans) / scale; views
        # without a stored scale_mat pass through (trans 0, scale 1).
        trans = np.zeros((V, 3))
        scale = np.ones((V, 3))
        for v, i in enumerate(sel):
            key = "scale_mat_" + str(i)
            if key in cams:
                smat = cams[key]
                trans[v] = smat[:3, 3]
                scale[v] = np.diagonal(smat[:3, :3])
        poses[:, :3, 3] = (centers - trans) / scale

        fx = np.mean(K[:, 0, 0] * x_scale)
        fy = np.mean(K[:, 1, 1] * y_scale)
        cx = np.mean((K[:, 0, 2] + xy_delta) * x_scale)
        cy = np.mean((K[:, 1, 2] + xy_delta) * y_scale)
        focal = np.array([fx, fy], dtype=np.float32)
        c = np.array([cx, cy], dtype=np.float32)
        return poses.astype(np.float32), focal, c

    def _cameras_shapenet(self, cams, sel, x_scale):
        """All-view ShapeNet cameras: stored inverses used as-is, the
        rest inverted in one batched ``np.linalg.inv`` call; the shared
        focal is checked across views."""
        V = len(sel)
        poses = np.empty((V, 4, 4))
        to_invert, invert_rows = [], []
        for v, i in enumerate(sel):
            inv_key = "world_mat_inv_" + str(i)
            if inv_key in cams:
                poses[v] = cams[inv_key]
            else:
                extr = cams["world_mat_" + str(i)]
                if extr.shape[0] == 3:
                    extr = np.vstack((extr, np.array([0, 0, 0, 1])))
                to_invert.append(extr)
                invert_rows.append(v)
        if to_invert:
            poses[invert_rows] = np.linalg.inv(np.stack(to_invert))

        intr = np.stack([cams["camera_mat_" + str(i)] for i in sel])
        fxs, fys = intr[:, 0, 0], intr[:, 1, 1]
        assert np.max(np.abs(fxs - fys)) < 1e-9
        fxs = fxs * x_scale
        assert np.max(np.abs(fxs - fxs[0])) < 1e-5
        return poses.astype(np.float32), np.float32(fxs[0])

    def __getitem__(self, index):
        cat, root_dir = self.all_objs[index]
        rgb_paths, mask_paths, sel = self._select_views(root_dir)
        cams = np.load(os.path.join(root_dir, "cameras.npz"))

        is_shapenet = self.sub_format == "shapenet"
        imgs, masks, bboxes, widths, heights = self._read_images(
            rgb_paths, mask_paths, want_bboxes=is_shapenet
        )

        if self.scale_focal:
            x_scale = widths / 2.0
            y_scale = heights / 2.0
            xy_delta = 1.0
        else:
            x_scale = np.ones(len(rgb_paths))
            y_scale = np.ones(len(rgb_paths))
            xy_delta = 0.0

        c = None
        if self.sub_format == "dtu":
            poses, focal, c = self._cameras_dtu(
                cams, sel, x_scale, y_scale, xy_delta
            )
            all_bboxes = None
        else:
            poses, focal = self._cameras_shapenet(cams, sel, x_scale)
            all_bboxes = np.stack(bboxes) if bboxes else None

        # Both coordinate-convention transforms over the whole stack.
        all_poses = np.einsum(
            "ij,vjk,kl->vil",
            self._coord_trans_world, poses, self._coord_trans_cam,
        ).astype(np.float32)

        all_imgs = np.stack(imgs)
        all_masks = np.stack(masks) if masks else None

        if self.image_size is not None and all_imgs.shape[-2:] != tuple(
            self.image_size
        ):
            scale = self.image_size[0] / all_imgs.shape[-2]
            focal = focal * scale
            if self.sub_format != "shapenet":
                c = c * scale
            elif all_bboxes is not None:
                all_bboxes = all_bboxes * scale
            all_imgs = area_resize_chw(all_imgs, tuple(self.image_size))
            if all_masks is not None:
                all_masks = area_resize_chw(all_masks, tuple(self.image_size))

        result = {
            "path": root_dir,
            "img_id": index,
            "focal": focal,
            "images": all_imgs,
            "poses": all_poses,
        }
        if all_masks is not None:
            result["masks"] = all_masks
        if self.sub_format != "shapenet":
            result["c"] = c
        else:
            result["bbox"] = all_bboxes
        return result
