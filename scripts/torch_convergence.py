#!/usr/bin/env python3
"""Convergence recipes of the PyTorch port (pixelnerf_yolo_torch), on
scenes held in memory.

    python scripts/torch_convergence.py early_term [--steps 300] [--size 64]
        [--rays 1024] [--fracs 0.5,0.375,0.25,0.125] [--image_size 128]
    python scripts/torch_convergence.py nerf_multiscene [--steps 2000]
        [--rays 512] [--image_size 128]
    python scripts/torch_convergence.py yolo [--epochs 20]
    python scripts/torch_convergence.py yolo3s [--epochs 24]
        [--grid 0.45,0.6,0.75,0.9,0.97]

Every subcommand also takes --device (default cuda), --workdir (default a
temporary directory: checkpoints/, logs/ and visuals/ go there), --out FILE
(the JSON line is written there too) and --set KEY=VALUE (a conf override,
repeatable; the value is read as JSON where it parses, else as a string),
which the toy runs of tests/test_torch_convergence_scenes.py use.

Each recipe is the JAX package's, as CONVERGENCE.md records it:
  early_term       scripts/early_term_eval.py: the single-scene overfit
                   (bf16, 1024 rays a step), then a novel view rendered
                   ungated and at each gating fraction f
  nerf_multiscene  tests/test_convergence.py::
                   test_nerf_multiscene_generalizes at its chip point
                   (2000 steps of SB=2 x 512 rays, bf16): held-out-scene
                   PSNR before and after
  yolo             scripts/convergence_yolo.sh: conf/exp/yolo.conf, -V 3
                   -B 1 --gamma 0.9, Trainer.start (latest and best-F1
                   checkpoints), then eval_yolo's evaluate on both
  yolo3s           scripts/convergence_yolo3s.sh: conf/exp/yolo_3scale.conf
                   on 4 randomized scenes (seed 11), evaluate on both
                   checkpoints, then the per-scale calibration over --grid
                   on the latest and evaluate at its best thresholds
The scenes are tests/synth_data.py's, drawn from the same default_rng
sequence but built in memory, so neither imageio nor cv2 is needed:
``yolo_scenes`` resizes by yolo.image_scale with cv2.INTER_LINEAR's
half-pixel bilinear (within one uint8 level of cv2's fixed point) and
``srn_scenes`` as the port's SRN reader does.  The NeRF recipe functions
take any (train, val) datasets; tests/test_torch_convergence.py runs them
on the disk readers.

Everything trains on the port's default route (model.use_fused_mlp =
auto: the field-MLP kernels on a CUDA device).  Each run prints one JSON
line last: its result, wall time (on the card the kernels are built
first, ``build_s``, outside the timed training), the card (nvidia-smi
name, power.limit),
the kernel launches per mode and variant (field_mlp.variant_launches) and,
per MLP, the kernel route it should take or the widths the kernels refuse
(``PixelNeRF._fuses``).  It exits 1 when a mode of that route launched no
kernel.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import textwrap
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# tests/test_train_integration.py's NERF_TRAIN_CONF at d_hidden = 128, as
# the JAX recipes use it
NERF_CONF = textwrap.dedent(
    """
    model {
        use_encoder = True
        use_xyz = True
        use_code = True
        code { num_freqs = 6
               freq_factor = 1.5
               include_input = True }
        use_viewdirs = True
        use_code_viewdirs = False
        mlp_coarse { type = resnet
                     n_blocks = 5
                     d_hidden = 128
                     combine_layer = 3
                     combine_type = average }
        mlp_fine { type = resnet
                   n_blocks = 5
                   d_hidden = 128
                   combine_layer = 3
                   combine_type = average }
        encoder { backbone = resnet18
                  pretrained = False
                  num_layers = 2
                  index_padding = zeros }
    }
    renderer { type = nerf
               n_coarse = 8
               n_fine = 4
               n_fine_depth = 2
               depth_std = 0.01
               sched = []
               white_bkgd = True }
    loss {
        rgb { use_l1 = False }
        rgb_fine { use_l1 = False }
        alpha { lambda_alpha = 0.0
                clamp_alpha = 100
                init_epoch = 5 }
        lambda_coarse = 1.0
        lambda_fine = 1.0
    }
    train { print_interval = 2
            save_interval = 50
            backup_interval = 1000
            vis_interval = 100
            eval_interval = 50
            metric_interval = 20
            accu_grad = 1
            num_epoch_repeats = 1 }
    """
)
YOLO_CONFS = {"yolo": "conf/exp/yolo.conf",
              "yolo3s": "conf/exp/yolo_3scale.conf"}
# make_yolo_dataset's fixed layout: (class, cx, cy, w, h, RGB)
YOLO_BOXES = [(0, 0.5, 0.5, 0.25, 0.3, [250, 60, 60]),
              (1, 0.3, 0.6, 0.1, 0.12, [60, 220, 80])]
YOLO_PALETTE = [[250, 60, 60], [60, 220, 80], [70, 110, 240],
                [240, 200, 60]]
# get_split_dataset's depth range for the yolo format; the SRN cars'
YOLO_NEAR, YOLO_FAR = 1.0, 13.0
SRN_NEAR, SRN_FAR = 0.8, 1.8


# -- scenes held in memory -----------------------------------------------------


def look_at(origin, target=np.zeros(3), up=np.array([0, 1, 0.0])):
    """tests/synth_data.py::_look_at: a float32 camera-to-world."""
    back = origin - target
    back = back / np.linalg.norm(back)
    right = np.cross(up, back)
    right = right / np.linalg.norm(right)
    upv = np.cross(back, right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, upv, back, origin
    return c2w


def resize_linear(img: np.ndarray, fx: float, fy: float) -> np.ndarray:
    """cv2.resize(img, (0, 0), fx=fx, fy=fy) with INTER_LINEAR, in float:
    the output size rounded from the scaled input size, each output pixel
    centre mapped to (d + 0.5) / scale - 0.5 and clamped to the edge
    pixels, rounded to uint8 (cv2's 11-bit fixed point differs by at most
    one level)."""
    h, w = img.shape[:2]
    oh, ow = int(round(h * fy)), int(round(w * fx))

    def axis(n_out, n_in, scale):
        src = (np.arange(n_out) + 0.5) / scale - 0.5
        i0 = np.floor(src).astype(np.int64)
        frac = src - i0
        frac[i0 < 0] = 0.0
        i0 = np.maximum(i0, 0)
        edge = i0 >= n_in - 1
        frac[edge] = 0.0
        i0[edge] = n_in - 1
        return i0, np.minimum(i0 + 1, n_in - 1), frac

    y0, y1, wy = axis(oh, h, fy)
    x0, x1, wx = axis(ow, w, fx)
    x = img.astype(np.float64)
    wx = wx[None, :, None]
    rows = [x[y][:, x0] * (1 - wx) + x[y][:, x1] * wx for y in (y0, y1)]
    out = rows[0] * (1 - wy)[:, None, None] + rows[1] * wy[:, None, None]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


class MemoryDataset:
    """A split of scenes held in memory, with the attributes of a disk
    reader that the trainers read.  Each item is returned as a new dict,
    so a wrapper that replaces its images (ColorJitterDataset) leaves the
    stored scene alone."""

    def __init__(self, items, z_near, z_far, base_path="memory"):
        from pixelnerf_yolo_torch.utils.image import image_to_tensor_balanced

        self.items = items
        self.z_near, self.z_far, self.lindisp = z_near, z_far, False
        self.base_path = base_path
        self.image_to_tensor = image_to_tensor_balanced

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index):
        return dict(self.items[index])


def yolo_scenes(conf, n_scenes=2, n_views=10, img_size=256, seed=4,
                randomize=False):
    """(train, val, test) as get_split_dataset("yolo") reads what
    tests/synth_data.py::make_yolo_dataset writes with these arguments:
    the same images (resized by yolo.image_scale), extrinsics (stored
    row-0-negated, negated back as the reader does) and boxes, with the
    grid targets of ``YOLODataset._get_all_bboxes`` at the conf's scales;
    train is every scene under ColorJitterDataset, val and test scene 0."""
    from pixelnerf_yolo_torch.data.color_jitter import ColorJitterDataset
    from pixelnerf_yolo_torch.data.yolo import YOLODataset
    from pixelnerf_yolo_torch.utils.image import image_to_tensor_balanced

    targets = YOLODataset.__new__(YOLODataset)
    targets.set_target_conf(conf)
    scale = conf["yolo.image_scale"]
    rng = np.random.default_rng(seed)
    K = np.array([[float(img_size), 0, img_size / 2],
                  [0, float(img_size), img_size / 2], [0, 0, 1]])
    items = []
    for s in range(n_scenes):
        if randomize:
            scene_boxes = []
            for b in range(int(rng.integers(2, 5))):
                small = b % 2 == 1
                bw = float(rng.uniform(0.06, 0.12) if small
                           else rng.uniform(0.2, 0.35))
                bh = float(rng.uniform(0.06, 0.12) if small
                           else rng.uniform(0.2, 0.35))
                cx = float(rng.uniform(bw / 2 + 0.02, 1 - bw / 2 - 0.02))
                cy = float(rng.uniform(bh / 2 + 0.02, 1 - bh / 2 - 0.02))
                scene_boxes.append((int(rng.integers(0, 2)), cx, cy, bw, bh,
                                    YOLO_PALETTE[b % len(YOLO_PALETTE)]))
        boxes = scene_boxes if randomize else YOLO_BOXES
        images, poses, grids = [], [], []
        for v in range(n_views):
            theta = 2 * np.pi * v / n_views
            origin = np.array([7 * np.sin(theta), 1.0, 7 * np.cos(theta)],
                              dtype=np.float32)
            stored = np.linalg.inv(look_at(origin)).astype(np.float64)
            stored[0] = -stored[0]
            pose = stored.astype(np.float32)
            pose[0] = pose[0] * -1
            poses.append(pose)
            img = rng.integers(0, 255, size=(img_size, img_size, 3),
                               dtype=np.uint8)
            for _, cx, cy, bw, bh, color in boxes:
                x0, x1 = (int((cx - bw / 2) * img_size),
                          int((cx + bw / 2) * img_size))
                y0, y1 = (int((cy - bh / 2) * img_size),
                          int((cy + bh / 2) * img_size))
                img[y0:y1, x0:x1] = color
            img = resize_linear(img, scale[0], scale[1])
            images.append(image_to_tensor_balanced(img))
            rows = [[cx, cy, bw, bh, float(cls)]
                    for cls, cx, cy, bw, bh, _ in boxes]
            grids.append(targets._get_all_bboxes(rows, img.shape[0],
                                                 img.shape[1]))
        items.append({
            "path": f"memory/scene_{s:03d}", "img_id": s,
            "focal": (K[0, 0] * np.array(scale)).astype(np.float32),
            "images": np.stack(images), "bboxes": grids,
            "poses": np.stack(poses),
            "c": (K[:2, 2] * np.array(scale)).astype(np.float32),
        })
    first = [dict(items[0], img_id=0)]
    return (ColorJitterDataset(MemoryDataset(items, YOLO_NEAR, YOLO_FAR)),
            MemoryDataset(first, YOLO_NEAR, YOLO_FAR),
            MemoryDataset(first, YOLO_NEAR, YOLO_FAR))


def srn_scenes(n_objs=2, n_views=6, img_size=32, seed=0,
               image_size=(128, 128)):
    """One stage of tests/synth_data.py::make_srn_dataset, as the port's
    SRN reader returns it (cars: near 0.8, far 1.8): the objects' images
    and masks resized to image_size, focal, c and bboxes scaled with
    them, poses with the camera flip."""
    from pixelnerf_yolo_torch.data.base import (area_resize_chw, mask_bbox,
                                                mask_to_tensor)
    from pixelnerf_yolo_torch.utils.image import image_to_tensor_balanced

    coord_trans = np.diag(np.array([1, -1, -1, 1], dtype=np.float32))
    rng = np.random.default_rng(seed)
    items = []
    for o in range(n_objs):
        obj_color = rng.integers(0, 200, size=3, dtype=np.uint8)
        focal, cx, cy = img_size * 1.2, img_size / 2, img_size / 2
        imgs, poses, masks, bboxes = [], [], [], []
        for v in range(n_views):
            theta = 2 * np.pi * v / n_views
            origin = np.array([1.3 * np.sin(theta), 0.3, 1.3 * np.cos(theta)],
                              dtype=np.float32)
            poses.append(look_at(origin) @ coord_trans)
            img = np.full((img_size, img_size, 3), 255, dtype=np.uint8)
            r, cc = img_size // 4, img_size // 2
            img[cc - r:cc + r, cc - r:cc + r] = obj_color
            mask = (img != 255).all(axis=-1)[..., None].astype(np.uint8) * 255
            imgs.append(image_to_tensor_balanced(img))
            masks.append(mask_to_tensor(mask))
            bboxes.append(mask_bbox(mask))
        imgs, masks, bboxes = np.stack(imgs), np.stack(masks), np.stack(bboxes)
        if imgs.shape[-2:] != tuple(image_size):
            s = image_size[0] / imgs.shape[-2]
            focal, cx, cy = focal * s, cx * s, cy * s
            bboxes = bboxes * s
            imgs = area_resize_chw(imgs, image_size)
            masks = area_resize_chw(masks, image_size)
        items.append({
            "path": f"memory/obj_{o:03d}", "img_id": o,
            "focal": np.float32(focal),
            "c": np.array([cx, cy], dtype=np.float32), "images": imgs,
            "masks": masks, "bbox": bboxes, "poses": np.stack(poses),
        })
    return MemoryDataset(items, SRN_NEAR, SRN_FAR)


# -- shared -------------------------------------------------------------------


def nvidia_smi() -> str:
    """nvidia-smi's "name, power.limit", or why there is none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"not available ({type(e).__name__})"


def jsonable(obj):
    """obj with numpy scalars as Python numbers and dict keys as str."""
    if isinstance(obj, dict):
        return {str(k): jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonable(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def device_name(device) -> str:
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def apply_sets(conf, sets) -> None:
    """--set KEY=VALUE overrides, the value read as JSON where it parses."""
    for item in sets or ():
        key, _, text = item.partition("=")
        try:
            value = json.loads(text)
        except json.JSONDecodeError:
            value = text
        conf.put(key, value)


def kernel_route(model, ns: int, device) -> dict:
    """The kernel modes each MLP of the model should launch at ns source
    views on ``device`` (none off CUDA, where the wrappers run their plain
    twins), and the MLPs whose widths the kernels refuse."""
    import torch

    expected, refused = [], []
    on_card = torch.device(device).type == "cuda"
    for name in ("mlp_coarse", "mlp_fine"):
        mlp = getattr(model, name)
        if mlp is None:
            continue
        if not model._fuses(mlp, ns):
            refused.append({"mlp": name, "d_hidden": mlp.d_hidden,
                            "d_latent": mlp.d_latent, "d_in": model.d_in,
                            "d_out": mlp.d_out,
                            "compute_dtype": str(model.compute_dtype)})
            continue
        first = model._first_kernel(mlp, ns, model._pe_fusible())
        for mode in (first,) if first == "full_pe" else (first,
                                                         "post_combine"):
            if on_card and mode not in expected:
                expected.append(mode)
    return {"expected": expected, "refused": refused}


def route_ok(route: dict, launches: dict) -> bool:
    """Whether every expected mode launched (summed over variants)."""
    got = {}
    for key, n in launches.items():
        got[key.split("/")[0]] = got.get(key.split("/")[0], 0) + n
    return all(got.get(mode, 0) > 0 for mode in route["expected"])


@contextlib.contextmanager
def counted(record: dict, key: str):
    """Zero the kernel launch counters, run the block, store the counts in
    record[key]."""
    from pixelnerf_yolo_torch.ops import field_mlp

    field_mlp.reset_launches()
    try:
        yield
    finally:
        record[key] = dict(field_mlp.variant_launches)


# -- NeRF recipes -------------------------------------------------------------


def nerf_conf(dtype=None, sets=None):
    from pixelnerf_yolo_torch.config.hocon import parse_string

    conf = parse_string(NERF_CONF)
    if dtype is not None:
        conf.put("model.compute_dtype", dtype)
    apply_sets(conf, sets)
    return conf


def nerf_args(workdir, name, **extra):
    """tests/test_train_integration.py::make_args with the overrides."""
    args = argparse.Namespace(
        name=name, resume=False, gpu_id=[0],
        logs_path=os.path.join(workdir, "logs"),
        checkpoints_path=os.path.join(workdir, "checkpoints"),
        visual_path=os.path.join(workdir, "visuals"), epochs=1, lr=1e-4,
        gamma=1.0, ray_batch_size=32, batch_size=1, nviews="3",
        freeze_enc=None, no_bbox_step=100000, fixed_test=None, seed=0)
    for key, value in extra.items():
        setattr(args, key, value)
    for d in (os.path.join(args.checkpoints_path, name),
              os.path.join(args.visual_path, name), args.logs_path):
        os.makedirs(d, exist_ok=True)
    return args


def nerf_trainer(conf, dset, val_dset, workdir, name, device, **extra):
    """The recipes' NeRF trainer: make_model (seed 0) / make_renderer /
    make_trainer on ``device``, NS = 2."""
    from pixelnerf_yolo_torch.models import make_model
    from pixelnerf_yolo_torch.render import make_renderer
    from pixelnerf_yolo_torch.train import make_trainer

    args = nerf_args(workdir, name, **extra)
    model = make_model(conf.get_config("model"), device=device)
    renderer = make_renderer(conf, device=device)
    return make_trainer(args, conf, dset, val_dset, model, renderer, [2],
                        device=device)


def overfit_trainer(dset, val_dset, workdir, name, rays, device, dtype=None,
                    sets=None):
    """The single-scene overfit recipe's trainer and its one batch
    (nviews 2, lr 5e-4, no_bbox_step 0)."""
    from pixelnerf_yolo_torch.data import DataLoader

    trainer = nerf_trainer(nerf_conf(dtype, sets), dset, val_dset, workdir,
                           name, device, nviews="2", ray_batch_size=rays,
                           lr=5e-4, no_bbox_step=0)
    return trainer, next(iter(DataLoader(dset, batch_size=1)))


def held_out_psnr(trainer, val_dset, device) -> float:
    """Held-out-scene novel-view PSNR: condition on views (0, 1), render
    view 4, average over the val scenes (the JAX test's val_psnr)."""
    import torch

    from pixelnerf_yolo_torch.data import DataLoader
    from pixelnerf_yolo_torch.utils.camera import gen_rays
    from pixelnerf_yolo_torch.utils.metrics import psnr

    vals = []
    for data in DataLoader(val_dset, batch_size=1, shuffle=False):
        images, poses = data["images"][0], data["poses"][0]
        focal = data["focal"][0]
        _, _, H, W = images.shape
        with torch.no_grad():
            cond = trainer.model.encode(images[[0, 1]][None],
                                        poses[[0, 1]][None], focal)
        rays = gen_rays(torch.as_tensor(poses[4:5], device=device), W, H,
                        torch.as_tensor(focal), trainer.z_near,
                        trainer.z_far).reshape(1, -1, 8)
        out = trainer.renderer(trainer.model, cond, rays,
                               generator=torch.Generator(
                                   device=device).manual_seed(0))
        branch = "fine" if "fine" in out else "coarse"
        pred = out[branch]["rgb"].float().cpu().numpy().reshape(H, W, 3)
        vals.append(float(psnr(pred, images[4].transpose(1, 2, 0) * 0.5
                               + 0.5)))
    return float(np.mean(vals))


def nerf_multiscene(dset, val_dset, workdir, steps=80, rays=256,
                    dtype="bfloat16", device="cuda", sets=None) -> dict:
    """The held-out recipe: SB=2 scenes a step, ``rays`` rays each, nviews
    2, lr 5e-4, no_bbox_step 0; held-out PSNR before and after."""
    from pixelnerf_yolo_torch.data import DataLoader

    trainer = nerf_trainer(nerf_conf(dtype, sets), dset, val_dset, workdir,
                           "multiscene", device, nviews="2",
                           ray_batch_size=rays, lr=5e-4, no_bbox_step=0,
                           batch_size=2)
    res = {"steps": steps, "rays": rays, "scenes_per_step": 2,
           "dtype": dtype,
           "route": kernel_route(trainer.model, 2, device)}
    psnr0 = held_out_psnr(trainer, val_dset, device)
    loader = DataLoader(dset, batch_size=2, shuffle=True, seed=3)
    it = iter(loader)
    step = 0
    t0 = time.perf_counter()
    with counted(res, "train_launches"):
        while step < steps:
            try:
                batch = next(it)
            except StopIteration:
                it = iter(loader)
                continue
            losses = trainer.train_step(batch, step)
            if step == 0:
                res["first_losses"] = {k: float(v) for k, v in losses.items()}
            step += 1
            if step % 50 == 0:
                float(losses["t"])  # bound the queue of launched steps
        res["loss"] = float(losses["t"])
    res["train_s"] = time.perf_counter() - t0
    with counted(res, "eval_launches"):
        psnr1 = held_out_psnr(trainer, val_dset, device)
    res.update(psnr0=psnr0, psnr=psnr1, gain=psnr1 - psnr0)
    return res


def early_term(dset, val_dset, workdir, steps=300, rays=1024,
               fracs=(0.5, 0.375, 0.25, 0.125), dtype="bfloat16",
               device="cuda", sets=None) -> dict:
    """scripts/early_term_eval.py: train the overfit recipe, then render
    view 4 conditioned on views (0, 1), ungated and at each gating
    fraction f: PSNR against the ground truth and against the ungated
    render, the fine-pass rays of a chunk and the share of rays gated."""
    import torch

    from pixelnerf_yolo_torch.utils.camera import gen_rays
    from pixelnerf_yolo_torch.utils.metrics import psnr

    trainer, batch = overfit_trainer(dset, val_dset, workdir, "et_eval",
                                     rays, device, dtype, sets)
    model, renderer = trainer.model, trainer.renderer
    res = {"steps": steps, "rays": rays, "dtype": dtype,
           "route": kernel_route(model, 2, device)}
    t0 = time.perf_counter()
    with counted(res, "train_launches"):
        for step in range(steps):
            losses = trainer.train_step(batch, step)
        res["loss"] = float(losses["t"])
    res["train_s"] = time.perf_counter() - t0

    images, poses = batch["images"][0], batch["poses"][0]
    focal = batch["focal"][0]
    H, W = images.shape[-2:]
    with torch.no_grad():
        cond = model.encode(images[None, (0, 1)], poses[None, (0, 1)], focal)
    tgt = 4
    rays_t = gen_rays(torch.as_tensor(poses[tgt:tgt + 1], device=device), W,
                      H, torch.as_tensor(focal), 0.8, 1.8).reshape(1, -1, 8)
    gt = images[tgt].transpose(1, 2, 0) * 0.5 + 0.5

    def render_with(r):
        out = r(model, cond, rays_t,
                generator=torch.Generator(device=device).manual_seed(7),
                want_weights=True)
        rgb = out["fine"]["rgb"][0].float().cpu().numpy().reshape(H, W, 3)
        return rgb, out["coarse"]["weights"][0].float().cpu().numpy()

    with counted(res, "eval_launches"):
        rgb0, w_c = render_with(renderer)
        res["psnr_ungated"] = float(psnr(rgb0, gt))
        res["foreground"] = float((w_c.sum(-1) > 0.5).mean())
        cb = renderer._chunk_rays(rays_t.shape[1], 2, model.latent_width(2))
        sweep = []
        for f in fracs:
            r = dataclasses.replace(renderer, early_terminate=float(f))
            rgb, _ = render_with(r)
            mse = float(np.mean((rgb - rgb0) ** 2))
            kept = r._gated_capacity(cb)
            sweep.append({
                "f": float(f), "psnr_gt": float(psnr(rgb, gt)),
                "delta_db": float(psnr(rgb, gt)) - res["psnr_ungated"],
                "psnr_vs_ungated": (float("inf") if mse == 0
                                    else -10.0 * float(np.log10(mse))),
                "fine_rays_per_chunk": kept, "chunk_rays": cb,
                "gated_share": 1.0 - kept / cb,
            })
        res["sweep"] = sweep
    return res


# -- YOLO recipes -------------------------------------------------------------


def yolo_recipe(recipe, workdir, epochs, device="cuda", sets=None,
                grid=None) -> dict:
    """scripts/convergence_yolo{,3s}.sh on scenes held in memory: the
    train CLI's flags (-V 3 -B 1 --gamma 0.9 --epochs), Trainer.start, then
    eval_yolo's flags and evaluate on the latest and the best-F1
    checkpoint (and for yolo3s the calibration over ``grid``)."""
    import torch

    from pixelnerf_yolo_torch.config.args import parse_args
    from pixelnerf_yolo_torch.eval import eval_yolo
    from pixelnerf_yolo_torch.train import __main__ as train_cli
    from pixelnerf_yolo_torch.train import checkpoints

    conf_path = str(REPO / YOLO_CONFS[recipe])
    dirs = ["--logs_path", os.path.join(workdir, "logs"),
            "--checkpoints_path", os.path.join(workdir, "checkpoints"),
            "--visual_path", os.path.join(workdir, "visuals"),
            "--device", device]
    common = ["-n", recipe, "-F", "yolo", "-c", conf_path, "-D", workdir]
    args, conf = parse_args(
        train_cli.extra_args, training=True, default_ray_batch_size=128,
        argv=common + ["-V", "3", "-B", "1", "--gamma", "0.9", "--epochs",
                       str(epochs)] + dirs)
    apply_sets(conf, sets)
    data = ({"n_scenes": 4, "seed": 11, "randomize": True}
            if recipe == "yolo3s" else {"n_scenes": 2, "seed": 4})
    splits = yolo_scenes(conf, n_views=10, img_size=256, **data)

    trainer = train_cli.build_trainer(args, conf, resume=False, splits=splits)
    steps_per_epoch = trainer.num_epoch_repeats * len(
        trainer.train_data_loader)
    res = {"epochs": epochs, "steps": epochs * steps_per_epoch,
           "steps_per_epoch": steps_per_epoch, "data": data,
           "dtype": str(trainer.model.compute_dtype).split(".")[-1],
           "route": kernel_route(trainer.model, 3, device),
           "in_train_metrics": []}
    done = [0]
    train_step, metric_step = trainer.train_step, trainer.metric_step

    def recording_train_step(data, global_step=None, **kw):
        losses = train_step(data, global_step=global_step, **kw)
        if done[0] == 0:
            res["first_losses"] = {k: float(v) for k, v in losses.items()}
        done[0] += 1
        return losses

    def recording_metric_step(loader, print_hc=False):
        p, r, f1 = metric_step(loader, print_hc)
        res["in_train_metrics"].append({
            "epoch": (done[0] - 1) // steps_per_epoch, "step": done[0],
            "precision": p, "recall": r, "f1": f1})
        return p, r, f1

    trainer.train_step = recording_train_step
    trainer.metric_step = recording_metric_step
    t0 = time.perf_counter()
    with counted(res, "train_launches"):
        res["stop"] = trainer.start()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    res["train_s"] = time.perf_counter() - t0
    del trainer
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    eargs, econf = parse_args(eval_yolo.extra_args, training=True,
                              default_ray_batch_size=128,
                              argv=common + dirs)
    apply_sets(econf, sets)
    t0 = time.perf_counter()
    with counted(res, "eval_launches"):
        etrainer, test = eval_yolo.build_trainer(eargs, econf, splits=splits)
        res["latest"] = eval_yolo.evaluate(etrainer, test)
        if grid is not None:
            cal = eval_yolo.evaluate(etrainer, test, calibrate=grid)
            ranked = sorted(cal["results"],
                            key=lambda r: (-r["f1"], -r["map50"]))
            res["calibration"] = {"grid": list(grid), "top": ranked[:5]}
            etrainer.nms_threshold_per_scale = list(cal["best"]["taus"])
            res["latest_calibrated"] = eval_yolo.evaluate(etrainer, test)
            etrainer.nms_threshold_per_scale = None
        best = os.path.join(checkpoints.ckpt_dir(eargs),
                            "pixel_nerf_backup_best")
        res["best"] = None
        if os.path.exists(best):
            etrainer.model.load_state_dict(checkpoints.load_state(best))
            res["best"] = eval_yolo.evaluate(etrainer, test)
    res["eval_s"] = time.perf_counter() - t0
    return res


# -- command line -------------------------------------------------------------


def _floats(text: str) -> list:
    return [float(t) for t in text.split(",")]


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="recipe", required=True)
    cmds = {name: sub.add_parser(name) for name in
            ("early_term", "nerf_multiscene", "yolo", "yolo3s")}
    for p in cmds.values():
        p.add_argument("--device", default="cuda")
        p.add_argument("--workdir", default=None)
        p.add_argument("--out", default=None)
        p.add_argument("--set", action="append", default=[],
                       metavar="KEY=VALUE")
    cmds["early_term"].add_argument("--steps", type=int, default=300)
    cmds["early_term"].add_argument("--size", type=int, default=64)
    cmds["early_term"].add_argument("--rays", type=int, default=1024)
    cmds["early_term"].add_argument("--fracs", type=_floats,
                                    default=[0.5, 0.375, 0.25, 0.125])
    cmds["nerf_multiscene"].add_argument("--steps", type=int, default=2000)
    cmds["nerf_multiscene"].add_argument("--rays", type=int, default=512)
    for name in ("early_term", "nerf_multiscene"):
        cmds[name].add_argument("--image_size", type=int, default=128,
                                help="the side the SRN reader resizes to")
    cmds["yolo"].add_argument("--epochs", type=int, default=20)
    cmds["yolo3s"].add_argument("--epochs", type=int, default=24)
    cmds["yolo3s"].add_argument("--grid", type=_floats,
                                default=[0.45, 0.6, 0.75, 0.9, 0.97])
    return ap.parse_args(argv)


def run(a, workdir) -> dict:
    if a.recipe in ("early_term", "nerf_multiscene"):
        side = (a.image_size, a.image_size)
    if a.recipe == "early_term":
        dset, val = (srn_scenes(n_objs=1, n_views=8, img_size=a.size,
                                image_size=side) for _ in range(2))
        return early_term(dset, val, workdir, a.steps, a.rays, a.fracs,
                          device=a.device, sets=a.set)
    if a.recipe == "nerf_multiscene":
        dset = srn_scenes(n_objs=6, n_views=8, img_size=32, image_size=side)
        val = srn_scenes(n_objs=2, n_views=8, img_size=32, seed=77,
                         image_size=side)
        return nerf_multiscene(dset, val, workdir, a.steps, a.rays,
                               device=a.device, sets=a.set)
    return yolo_recipe(a.recipe, workdir, a.epochs, a.device, a.set,
                       getattr(a, "grid", None))


def main(argv=None) -> int:
    import torch

    from pixelnerf_yolo_torch.ops import field_mlp

    a = parse(argv)
    t0 = time.perf_counter()
    build_s = None
    if torch.device(a.device).type == "cuda":
        # f32 recipes in full f32, as the JAX package's precision="highest"
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # build the kernels before the timed training, not at its first step
        field_mlp.load_library()
        build_s = time.perf_counter() - t0
    with contextlib.ExitStack() as stack:
        workdir = a.workdir or stack.enter_context(
            tempfile.TemporaryDirectory())
        res = run(a, workdir)
    ok = route_ok(res["route"], res["train_launches"]) and route_ok(
        res["route"], res["eval_launches"])
    line = {"recipe": a.recipe, "ok": ok, "device": device_name(a.device),
            "nvidia_smi": nvidia_smi(), "build_s": build_s,
            "wall_s": time.perf_counter() - t0, **res}
    text = json.dumps(jsonable(line))
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(text + "\n")
    if not ok:
        print(f"{a.recipe}: a mode of the kernel route "
              f"{res['route']['expected']} launched no kernel",
              file=sys.stderr)
    print(text, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
