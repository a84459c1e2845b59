"""The operating points the port is driven and profiled at: the scenes
and in-memory datasets of ``chip_smoke.py``'s phases and of
``python -m pixelnerf_yolo_torch.profile_trace``.

``flagship_scene`` is the bench headline scene (``bench.py``'s ``nerf``
config); ``yolo_scene`` the YOLO flagship's (its views keep a real share
of the samples in front of the source cameras' z = 0 plane);
``train_dataset`` the one scene of ``bench.py``'s ``train_yolo`` point and
``nerf_train_dataset`` the SRN-format scene of its ``train_nerf`` point,
both held in memory (no image files, so neither imageio nor cv2); with
more scenes and smaller views they are the datasets of the port bench's
``train_scaling``."""

from __future__ import annotations

# The YOLO scene: tests/torch_parity.py (yolo_extrinsics, yolo_scene)
# holds the same numbers for the CPU tests; a change here goes there too.
YOLO_NEAR, YOLO_FAR = 1.0, 3.0
# train_yolo: 128x128 views, 4 a scene, NS=3 of them
TRAIN_SIZE, TRAIN_VIEWS, TRAIN_NS = 128, 4, 3
# [x, y, w, h, class] of each view's objects (fractions of the view)
TRAIN_BOXES = [[0.30, 0.40, 0.06, 0.05, 0], [0.70, 0.60, 0.04, 0.08, 1],
               [0.55, 0.20, 0.03, 0.03, 0]]
# train_nerf: 6 views of 128x128; SRN cars' z bounds
NERF_TRAIN_SIZE, NERF_TRAIN_VIEWS = 128, 6
NERF_NEAR, NERF_FAR = 0.8, 1.8


def flagship_scene(ns, n_rays, device):
    """The bench headline scene: 128x128 source views, camera 1.3 from the
    origin, focal 120, rays of a square image at near 0.8, far 1.8."""
    import numpy as np
    import torch

    from pixelnerf_yolo_torch.utils.camera import gen_rays

    rng = np.random.default_rng(0)
    images = rng.normal(size=(1, ns, 3, 128, 128)).astype(np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32) for _ in range(ns)])
    poses[:, 2, 3] = 1.3
    poses[:, 0, 3] = np.linspace(-0.1, 0.1, ns)
    side = int(round(n_rays ** 0.5))
    rays = gen_rays(torch.from_numpy(poses[:1]).to(device), side, side,
                    torch.tensor(120.0), 0.8, 1.8).reshape(1, -1, 8)
    return images.clip(-1, 1), poses[None], np.float32(120.0), rays


def yolo_scene(ns, size, seed=0):
    """(1, NS, 3, S, S) images, (1, NS, 4, 4) world-to-camera extrinsics,
    focal (1, 2), c (1, 2) and the target camera's (1, 4, 4) extrinsic.
    The target camera sits at the origin looking down +z; its samples lie
    at world z in [near, far].  View 0 sits (near + far) / 2 behind it
    (samples on both sides of its z = 0); views 1 and 2 are the target
    camera turned 180 degrees about y (every sample at camera z < 0, where
    YOLO mode keeps the latent), the second moved sideways."""
    import numpy as np

    flip = np.diag([-1.0, 1.0, -1.0, 1.0]).astype(np.float32)
    views = [np.eye(4, dtype=np.float32), flip.copy(), flip.copy()]
    views[0][:3, 3] = [0.05, -0.03, -(YOLO_NEAR + YOLO_FAR) / 2]
    views[2][:3, 3] = [0.1, 0.05, 0.0]
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(1, ns, 3, size, size)).astype(np.float32)
    focal = np.full((1, 2), size * 0.9, np.float32)
    c = np.full((1, 2), size / 2.0, np.float32)
    return (images.clip(-1, 1), np.stack(views[:ns])[None], focal, c,
            np.eye(4, dtype=np.float32)[None])


def train_dataset(conf, size=TRAIN_SIZE, extra=None, n_scenes=1):
    """n_scenes scenes held in memory: seeded size x size images (scene s
    from seed 4 + s), the extrinsics of ``yolo_scene`` (its 3 source views
    and the target camera) and grid targets at each of the conf's scales
    from the port's ``YOLODataset._get_all_bboxes``, of TRAIN_BOXES and of
    the [x, y, w, h, class] boxes that extra ({view: boxes}, optional) adds
    to a view.  No image files, so neither imageio nor cv2 is needed."""
    import numpy as np

    from pixelnerf_yolo_torch.data.yolo import YOLODataset

    _, poses, focal, c, target = yolo_scene(TRAIN_NS, size)

    class MemoryYOLODataset(YOLODataset):
        def __init__(self):
            self.set_target_conf(conf)
            self.z_near, self.z_far, self.lindisp = YOLO_NEAR, YOLO_FAR, False
            shift = np.array([0.05, 0.03, 0, 0, 0])
            bboxes = [self._get_all_bboxes(
                (np.array(TRAIN_BOXES) + v * shift).tolist()
                + (extra or {}).get(v, []), size, size)
                for v in range(TRAIN_VIEWS)]
            self.items = []
            for s in range(n_scenes):
                rng = np.random.default_rng(4 + s)
                images = rng.normal(size=(TRAIN_VIEWS, 3, size,
                                          size)).astype(np.float32)
                self.items.append({
                    "path": "memory", "img_id": s, "focal": focal[0],
                    "c": c[0], "images": images.clip(-1, 1),
                    "poses": np.concatenate([poses[0], target]),
                    "bboxes": bboxes})

        def __len__(self):
            return len(self.items)

        def __getitem__(self, index):
            return self.items[index]

    return MemoryYOLODataset()


def look_at(origin, target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)):
    """Camera-to-world (OpenGL: the camera looks down its -z) at origin,
    looking at target."""
    import numpy as np

    origin, target, up = (np.asarray(v, np.float64)
                          for v in (origin, target, up))
    back = origin - target
    back /= np.linalg.norm(back)
    right = np.cross(up, back)
    right /= np.linalg.norm(right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = right, np.cross(back, right), back
    c2w[:3, 3] = origin
    return c2w.astype(np.float32)


def nerf_train_dataset(size=NERF_TRAIN_SIZE, n_objs=1):
    """n_objs SRN-format scenes held in memory (no image files, so neither
    imageio nor cv2): 6 views of a seeded textured object (object o from
    seed 6 + o) on a white background, cameras on a ring 1.3 from the
    origin looking at it, the object's box in each view from
    ``data.base.mask_bbox``, poses in the SRN dataset's convention
    (camera-to-world times diag(1, -1, -1, 1))."""
    import numpy as np

    from pixelnerf_yolo_torch.data.base import (image_to_tensor_balanced,
                                                mask_bbox)

    S, V = size, NERF_TRAIN_VIEWS
    flip = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    yy, xx = np.mgrid[0:S, 0:S]
    items = []
    for o in range(n_objs):
        rng = np.random.default_rng(6 + o)
        images, poses, bboxes = [], [], []
        for v in range(V):
            theta = 2 * np.pi * v / V
            c2w = look_at([1.3 * np.sin(theta), 0.3, 1.3 * np.cos(theta)])
            poses.append(c2w @ flip)
            # an ellipse whose centre and size move with the view, filled
            # with a seeded color field
            cx, cy = S / 2 + 8 * np.sin(theta), S / 2 + 4 * np.cos(theta)
            inside = (((xx - cx) / (0.28 * S)) ** 2
                      + ((yy - cy) / (0.22 * S)) ** 2) <= 1.0
            img = np.full((S, S, 3), 255, np.uint8)
            tex = rng.integers(20, 230, size=(S // 8, S // 8, 3))
            img[inside] = np.kron(tex, np.ones((8, 8, 1)))[inside]
            images.append(image_to_tensor_balanced(img))
            bboxes.append(mask_bbox(inside[..., None], "memory"))
        items.append({"path": "memory", "img_id": o,
                      "focal": np.float32(1.2 * S),
                      "c": np.array([S / 2, S / 2], np.float32),
                      "images": np.stack(images), "bbox": np.stack(bboxes),
                      "poses": np.stack(poses).astype(np.float32)})

    class MemorySRNDataset:
        z_near, z_far, lindisp = NERF_NEAR, NERF_FAR, False

        def __len__(self):
            return len(items)

        def __getitem__(self, index):
            return items[index]

    return MemorySRNDataset()
