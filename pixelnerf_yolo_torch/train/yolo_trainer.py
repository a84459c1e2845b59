"""YOLO (detection-mode) trainer.

Counterpart of pixelnerf_yolo_tpu/train/yolo_trainer.py on one device:
  * per scene: rays for the selected source views as render targets
    (``gen_rays_yolo_np`` at the cell-scaled H, W, focal and c) and the
    grid targets per cell, padded to whole chunks of yolo.ray_batch_size
    rays with ignore-flag targets (prob -1), which drop out of every masked
    mean (``_assemble``, the JAX package's numpy code and view choice);
  * the gradient is that of the SUM of the chunk losses (the reference
    backpropagates each chunk); the reported losses are their mean over
    the real chunks;
  * BatchNorm runs on the batch's statistics in a train step and updates
    the running ones, unless the encoder is frozen (``--freeze_enc``:
    eval-mode BatchNorm, detached latent); an eval step changes nothing;
  * vis_step / metric_step render a destination view, decode the cells,
    run NMS and count TP/FP/FN (``detect.tp_fp_fn_padded`` on the device,
    or the host list path with ``--host_nms``).
The field runs through the fused kernels when the model takes them
(``PixelNeRF._can_fuse``): kernel forward, plain-module backward.

The coarse draws come from a ``torch.Generator`` seeded ``seed + 2`` on
the trainer's device, or are given (``u=``) as the JAX package's
``jax.random`` would make them.  The multi-scale YOLO path
(ROADMAP.md Queue 1 item 16), ``map_step`` and ``calibrate_scales``
(item 18) and multi-GPU (item 20) are not ported yet.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..detect.boxes import (
    calculate_precision_recall_f1,
    calculate_tp_fp_fn,
    convert_cells_to_bboxes,
    draw_bounding_boxes,
    nms,
)
from ..detect.nms import tp_fp_fn_padded
from ..losses.yolo import YoloLoss
from ..utils import camera
from . import checkpoints
from .trainer import Trainer

LOSS_KEYS = ("t", "box_loss", "object_loss", "no_object_loss", "class_loss")


class YOLOTrainer(Trainer):
    def __init__(self, args, conf, dset, val_dset, model, renderer, nviews,
                 device="cuda"):
        super().__init__(dset, val_dset, args, conf.get_config("train"))
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.renderer = renderer
        self.conf = conf
        self.dset = dset
        self.nviews = nviews
        self.renderer_state_path = os.path.join(
            args.checkpoints_path, args.name, "_renderer"
        )
        self.z_near = dset.z_near
        self.z_far = dset.z_far

        self.num_scales = conf["model.mlp_coarse.num_scales"]
        if self.num_scales > 1:
            raise NotImplementedError(
                "multi-scale YOLO training is not ported yet (ROADMAP.md "
                "Queue 1 item 16)")
        self.num_anchors_per_scale = conf[
            "model.mlp_coarse.num_anchors_per_scale"
        ]
        self.cell_sizes = conf["yolo.cell_sizes"][: self.num_scales]
        self.anchors = np.asarray(
            conf["yolo.anchors"][: self.num_scales], dtype=np.float32
        )  # (num_scales, A, 2)
        self.ray_batch_size = conf["yolo.ray_batch_size"]
        self.use_host_nms = bool(getattr(args, "host_nms", False))
        self.nms_max_out = conf.get_int("yolo.nms_max_out", 64)
        self.yolo_loss = YoloLoss.from_conf(conf, self.num_anchors_per_scale)
        self.early_restart = conf["yolo.early_restart"]
        self.nms_iou_threshold = conf["yolo.nms_iou_threshold"]
        self.nms_threshold = conf["yolo.nms_threshold"]
        self.metric_views = conf["yolo.metric_views"]
        self.match_iou_threshold = conf["yolo.match_iou_threshold"]
        print("n_coarse", conf["renderer.n_coarse"])
        print("nms_iou_threshold", self.nms_iou_threshold)
        print("nms_threshold", self.nms_threshold)
        print("match_iou_threshold", self.match_iou_threshold)

        checkpoints.load_weights(args, self.model)
        self.init_opt_state(self.model.parameters())

        seed = getattr(args, "seed", 0)
        self._rng = np.random.default_rng(seed + 1)
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 2)

    def save_model_state(self, epochNum: str = ""):
        checkpoints.save_weights(self.args, self.model, epochNum=epochNum)

    def extra_save_state(self):
        checkpoints.save_json(self.renderer_state_path, {})

    # -- batch assembly ----------------------------------------------------

    def _scale_rays_targets(self, poses, bboxes_scale, focal, c, H, W,
                            scale_idx, view_sel):
        """Rays and per-cell targets of the selected views at one scale."""
        cs = self.cell_sizes[scale_idx]
        cam_rays = camera.gen_rays_yolo_np(
            poses[view_sel], W // cs, H // cs, focal / cs, c / cs,
            self.z_near, self.z_far,
        ).reshape(-1, 8)
        bbox_gt = bboxes_scale[view_sel].reshape(
            -1, self.num_anchors_per_scale, 6)
        return cam_rays, bbox_gt

    def _assemble(self, data):
        """numpy (src_images, src_poses, focal, c, rays (SB, k, R, 8),
        targets (SB, k, R, A, 6), chunk anchors (k, A, 2), n_real)."""
        all_images = np.asarray(data["images"])  # (SB, NV, 3, H, W)
        all_poses = np.asarray(data["poses"])  # (SB, NV, 4, 4)
        all_bboxes = data["bboxes"]  # NV list of num_scales tuples, (SB,...)
        all_focals = np.asarray(data["focal"])  # (SB, 2)
        all_c = np.asarray(data["c"])  # (SB, 2)
        SB, NV, _, H, W = all_images.shape

        curr_nviews = self.nviews[
            int(self._rng.integers(0, len(self.nviews)))
        ]
        image_ord = np.empty((SB, curr_nviews), dtype=np.int64)
        R = self.ray_batch_size
        scene_rays, scene_targets = [], []
        scale_list = None
        for scene_idx in range(SB):
            image_ord[scene_idx] = self._rng.choice(
                NV, curr_nviews, replace=False
            )
            rays_list, targets_list, scales = [], [], []
            for scale_idx in range(self.num_scales):
                bboxes_at_scale = np.stack(
                    [np.asarray(all_bboxes[i][scale_idx])[scene_idx]
                     for i in range(len(all_bboxes))]
                )  # (NV, Hs, Ws, A, 6)
                rays, targets = self._scale_rays_targets(
                    all_poses[scene_idx], bboxes_at_scale,
                    all_focals[scene_idx], all_c[scene_idx], H, W,
                    scale_idx, image_ord[scene_idx],
                )
                # whole chunks per scale, padded with the first ray and
                # ignore-flag targets
                pad = (-rays.shape[0]) % R
                if pad:
                    rays = np.concatenate(
                        [rays, np.repeat(rays[:1], pad, 0)], 0)
                    pad_t = np.zeros((pad,) + targets.shape[1:],
                                     dtype=targets.dtype)
                    pad_t[..., 0] = -1.0
                    targets = np.concatenate([targets, pad_t], 0)
                rays_list.append(rays)
                targets_list.append(targets)
                scales.extend([scale_idx] * (rays.shape[0] // R))
            scene_rays.append(np.concatenate(rays_list, axis=0))
            scene_targets.append(np.concatenate(targets_list, axis=0))
            scale_list = scales  # the same for every scene (same NV, H, W)

        rays = np.stack(scene_rays)  # (SB, k*R, 8)
        targets = np.stack(scene_targets)
        k = rays.shape[1] // R
        rays = rays.reshape(SB, k, R, 8)
        targets = targets.reshape(SB, k, R, self.num_anchors_per_scale, 6)
        chunk_anchors = self.anchors[np.asarray(scale_list)]  # (k, A, 2)
        src_images = all_images[np.arange(SB)[:, None], image_ord]
        src_poses = all_poses[np.arange(SB)[:, None], image_ord]
        return (src_images, src_poses, all_focals, all_c, rays, targets,
                chunk_anchors, SB * k)

    # -- losses and the update -----------------------------------------------

    def compute_losses(self, src_images, src_poses, focal, c, rays, targets,
                       anchors, n_real, train: bool, u=None):
        """(loss for the gradient, {key: reported loss}).  The arrays are
        ``_assemble``'s; u optional (SB*k*R, n_coarse) coarse draws."""
        dev = self.device
        A = self.num_anchors_per_scale
        self._mark("start")
        cond = self.model.encode(src_images, src_poses, focal, c=c,
                                 train=train)
        self._mark("encoder")
        rays = torch.as_tensor(rays, dtype=torch.float32, device=dev)
        SB, k, chunk = rays.shape[:3]
        render = self.renderer.render(
            self.model, cond, rays.reshape(SB, k * chunk, 8),
            generator=self._gen, u=u,
        ).reshape(SB * k, chunk, A, 7)
        self._mark("render")
        targets = torch.as_tensor(targets, dtype=torch.float32, device=dev)
        targets = targets.reshape(SB * k, chunk, A, 6)
        anchors = torch.as_tensor(anchors, dtype=torch.float32, device=dev)
        losses = torch.stack([
            torch.stack(self.yolo_loss(render[i], targets[i],
                                       anchors[i % k]))
            for i in range(SB * k)
        ])  # (SB*k, 5)
        # the gradient of the SUM of the chunk losses (padding chunks are
        # all-ignore and add 0); the report averages over the real chunks
        total = losses[:, 0].sum()
        mean_losses = losses.detach().sum(dim=0) / n_real
        self._mark("loss")
        return total, dict(zip(LOSS_KEYS, mean_losses))

    def calc_losses(self, data, is_train=True, u=None):
        inputs = self._assemble(data)
        if not is_train:
            with torch.no_grad():
                return self.compute_losses(*inputs, train=False, u=u)[1]
        total, loss_dict = self.compute_losses(*inputs, train=True, u=u)
        self.backward_and_step(total)
        self._mark("adam")
        return loss_dict

    def train_step(self, data, global_step=None, u=None):
        return self.calc_losses(data, is_train=True, u=u)

    def eval_step(self, data, global_step=None, u=None):
        return self.calc_losses(data, is_train=False, u=u)

    # -- vis / metrics -------------------------------------------------------

    @torch.no_grad()
    def vis_step(self, data, global_step=None, idx=None, srcs=None,
                 dest=None, only_bbox=False):
        if "images" not in data:
            return {}
        batch_idx = (int(self._rng.integers(0, len(data["images"])))
                     if idx is None else idx)
        all_images = np.asarray(data["images"][batch_idx])  # (NV, 3, H, W)
        all_poses = np.asarray(data["poses"][batch_idx])
        all_bboxes = data["bboxes"]
        focal = np.asarray(data["focal"][batch_idx])  # (2,)
        c = np.asarray(data["c"][batch_idx])  # (2,)
        NV, _, H, W = all_images.shape

        curr_nviews = self.nviews[int(self._rng.integers(0, len(self.nviews)))]
        views_src = (np.sort(self._rng.choice(NV, curr_nviews, replace=False))
                     if srcs is None else np.asarray(srcs))
        view_dest = (int(self._rng.choice(views_src)) if dest is None
                     else int(dest))

        cond = self.model.encode(all_images[views_src][None],
                                 all_poses[views_src][None], focal[None],
                                 c=c[None])
        boxes_gt, boxes_predicted = [], []
        for scale_idx in range(self.num_scales):
            cs = self.cell_sizes[scale_idx]
            H_scaled, W_scaled = H // cs, W // cs
            cam_rays = camera.gen_rays_yolo(
                torch.as_tensor(all_poses, device=self.device), W_scaled,
                H_scaled, focal / cs, c / cs, self.z_near, self.z_far,
            )
            test_rays = cam_rays[view_dest].reshape(-1, 8)
            render = self.renderer(self.model, cond, test_rays,
                                   generator=self._gen)
            render = render.float().cpu().numpy().reshape(
                1, H_scaled, W_scaled, self.num_anchors_per_scale, 7)
            gt_grid = np.asarray(all_bboxes[view_dest][scale_idx])[
                batch_idx: batch_idx + 1]
            boxes_gt.append(convert_cells_to_bboxes(
                gt_grid, self.anchors[scale_idx], H_scaled, W_scaled,
                is_predictions=False)[0])
            boxes_predicted.append(convert_cells_to_bboxes(
                render, self.anchors[scale_idx], H_scaled, W_scaled,
                is_predictions=True)[0])
        boxes_gt = [b for sub in boxes_gt for b in sub]
        boxes_predicted = [b for sub in boxes_predicted for b in sub]
        if only_bbox:
            return boxes_gt, boxes_predicted

        boxes_gt, hc, bat = nms(boxes_gt, self.nms_iou_threshold,
                                self.nms_threshold)
        print("highest confidence:", hc)
        print("bboxes above threshold", self.nms_threshold, ":", bat)
        boxes_predicted, hc, bat = nms(boxes_predicted,
                                       self.nms_iou_threshold,
                                       self.nms_threshold)
        print("highest confidence:", hc)
        print("bboxes above threshold", self.nms_threshold, ":", bat)
        print("boxes predicted:", len(boxes_predicted))
        if (self.early_restart and len(boxes_predicted) == 0
                and len(boxes_gt) > 0):
            print("no boxes predicted")
            return None, None

        dest_img = all_images[view_dest].transpose(1, 2, 0) * 0.5 + 0.5
        source_views = ((all_images[views_src] * 0.5 + 0.5)
                        .transpose(0, 2, 3, 1).reshape(-1, H, W, 3))
        vis = np.hstack([*source_views, dest_img,
                         draw_bounding_boxes(dest_img, boxes_gt),
                         draw_bounding_boxes(dest_img, boxes_predicted)])
        return vis, None

    def _iter_metric_boxes(self, data_loader):
        """Every (scene x view triple x destination) of the metric
        protocol, rendered once: raw (bbox_gt, bbox_pred) decode lists."""
        for data in data_loader:
            for views in self.metric_views:
                views = np.array(views)
                for dest in views:
                    yield self.vis_step(data, idx=0, srcs=views, dest=dest,
                                        only_bbox=True)

    def _tp_fp_fn_one(self, bbox_gt, bbox_pred, print_hc=False):
        if self.use_host_nms:
            return calculate_tp_fp_fn(
                bbox_gt, bbox_pred, self.nms_iou_threshold,
                self.nms_threshold, self.match_iou_threshold,
                print_hc=print_hc,
            )
        gt_arr = np.asarray(bbox_gt, dtype=np.float32).reshape(-1, 6)
        pred_arr = np.asarray(bbox_pred, dtype=np.float32).reshape(-1, 6)
        if print_hc:
            hc = float(pred_arr[:, 1].max()) if len(pred_arr) else 0.0
            print(f"highest confidence: {hc}")
        # max_out grows (by powers of 2) to the candidate count, so the
        # kept-box cap never clips a dense scene; yolo.nms_max_out is the
        # floor
        need = max(len(gt_arr), len(pred_arr), 1)
        max_out = max(int(self.nms_max_out), 1)
        while max_out < need:
            max_out *= 2
        tp, fp, fn = tp_fp_fn_padded(
            torch.from_numpy(gt_arr).to(self.device),
            torch.from_numpy(pred_arr).to(self.device),
            self.nms_iou_threshold, self.nms_threshold,
            self.match_iou_threshold, max_out=max_out,
        )
        return int(tp), int(fp), int(fn)

    def _f1_from_boxes(self, boxes, print_hc=False):
        total_tp = total_fp = total_fn = 0
        for bbox_gt, bbox_pred in boxes:
            tp, fp, fn = self._tp_fp_fn_one(bbox_gt, bbox_pred, print_hc)
            total_tp += tp
            total_fp += fp
            total_fn += fn
        print("total_tp", total_tp, "total_fp", total_fp, "total_fn", total_fn)
        return calculate_precision_recall_f1(total_tp, total_fp, total_fn)

    def metric_step(self, data_loader, print_hc=False):
        return self._f1_from_boxes(self._iter_metric_boxes(data_loader),
                                   print_hc)

    def map_step(self, data_loader, iou_threshold=0.5):
        raise NotImplementedError(
            "map_step is not ported yet (ROADMAP.md Queue 1 item 18)")

    def calibrate_scales(self, data_loader, grid, iou_threshold=0.5):
        raise NotImplementedError(
            "calibrate_scales is not ported yet (ROADMAP.md Queue 1 item 18)")


def make_trainer(args, conf, dset, val_dset, model, renderer, nviews,
                 device="cuda"):
    """The trainer of the conf's renderer type, on ``device`` (the card
    unless the caller asks for the CPU)."""
    trainer_type = conf.get_string("renderer.type", "nerf")
    if trainer_type == "yolo":
        return YOLOTrainer(args, conf, dset, val_dset, model, renderer,
                           nviews, device=device)
    if trainer_type == "nerf":
        raise NotImplementedError(
            "the NeRF trainer is not ported yet (ROADMAP.md Queue 1 item 16)")
    raise NotImplementedError("Unsupported trainer type")
