"""PixelNeRF (NeRF-mode) trainer.

Counterpart of pixelnerf_yolo_tpu/train/nerf_trainer.py:
  * per scene, on the host: a random subset of source views, then the ray
    batch: pixels inside the scene's per-view bounding boxes until
    ``--no_bbox_step``, uniform over every view's pixels after it
    (``_assemble``: the JAX package's Generator calls, so that the same
    Generator stream picks the same views and pixels, with rays and
    colours built only for the drawn pixels);
  * the loss: the coarse and fine RGB criteria (``loss.rgb``, and
    ``loss.rgb_fine`` for the fine pass when the conf has it) as
    ``weighted_rgb_loss`` over the rays, weighted by lambda_coarse and
    lambda_fine;
  * BatchNorm runs on the batch's statistics in a train step and updates
    the running ones, unless the encoder is frozen (``--freeze_enc``);
    an eval step changes nothing and renders without sigma noise;
  * the renderer's sample-count schedule advances after every batch, and
    its state is saved beside the checkpoint (``_renderer``) and restored
    on resume;
  * vis_step renders an unseen view in full, with the depth and alpha
    colormap panels and the PSNR.
The field runs through the fused kernels when the model takes them
(``PixelNeRF._can_fuse``): kernel forward, plain-module backward.

The render's draws come from a ``torch.Generator`` seeded ``seed + 2`` on
the trainer's device, or are given (``draws=``, as
``NeRFRenderer.draw(..., train=True)`` returns them) as the JAX package's
``jax.random`` would make them.

On a training mesh (``mesh=``, trainer.py) the ray batch pads to the
mesh's ray multiple with rays of weight 0 (wrapped indices); the scenes
shard over 'data' when it divides SB and the rays over 'rays', otherwise
(the ragged variant) every rank takes every scene and the rays shard over
'data' x 'rays'.  Every rank draws the global draws and renders its part.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import parallel
from ..losses.rgb import get_rgb_loss, weighted_rgb_loss
from ..parallel.collectives import synced_batch_norm
from ..parallel.render import RenderParallel
from ..utils import camera
from ..utils.image import cmap
from ..utils.metrics import psnr as psnr_fn
from ..utils.profiling import count, scope
from ..utils.sampling import bbox_sample
from . import checkpoints
from .trainer import Trainer


class PixelNeRFTrainer(Trainer):
    def __init__(self, args, conf, dset, val_dset, model, renderer, nviews,
                 device="cuda", mesh=None):
        super().__init__(dset, val_dset, args, conf.get_config("train"))
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.renderer = renderer
        self.conf = conf
        self.dset = dset
        self.val_dset = val_dset
        self.nviews = nviews
        self.renderer_state_path = os.path.join(
            args.checkpoints_path, args.name, "_renderer"
        )

        self.lambda_coarse = conf.get_float("loss.lambda_coarse")
        self.lambda_fine = conf.get_float("loss.lambda_fine", 1.0)
        print("lambda coarse {} and fine {}".format(self.lambda_coarse,
                                                    self.lambda_fine))
        self.rgb_coarse_crit = get_rgb_loss(conf.get_config("loss.rgb"), True)
        fine_loss_conf = conf.get_config("loss.rgb")
        if "rgb_fine" in conf.get_config("loss"):
            print("using fine loss")
            fine_loss_conf = conf.get_config("loss.rgb_fine")
        self.rgb_fine_crit = get_rgb_loss(fine_loss_conf, False)

        self.renderer_sched_state = {"iter_idx": 0, "last_sched": 0}
        if args.resume and os.path.exists(self.renderer_state_path):
            self.renderer_sched_state = checkpoints.load_json(
                self.renderer_state_path)
            self.renderer, self.renderer_sched_state = renderer.sched_step(
                self.renderer_sched_state, 0)

        self.z_near = dset.z_near
        self.z_far = dset.z_far
        self.use_bbox = args.no_bbox_step > 0

        checkpoints.load_weights(args, self.model)
        self.bind_mesh(mesh)
        self.init_opt_state(self.model.parameters())

        seed = getattr(args, "seed", 0)
        self._rng = np.random.default_rng(seed + 1)
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 2)

    # -- persistence ---------------------------------------------------------

    def extra_save_state(self):
        checkpoints.save_json(self.renderer_state_path,
                              self.renderer_sched_state)

    def post_batch(self, epoch, batch):
        self.renderer, self.renderer_sched_state = self.renderer.sched_step(
            self.renderer_sched_state, self.args.batch_size)

    # -- batch assembly (host side) ------------------------------------------

    def _assemble(self, data, is_train, global_step):
        """numpy (src_images (SB, NS, 3, H, W), src_poses, focal, c or None,
        rays (SB, R, 8), rgb_gt (SB, R, 3), per-ray weights (SB, R))."""
        with scope("batch_assemble"):
            all_images = np.asarray(data["images"])  # (SB, NV, 3, H, W)
            SB, NV, _, H, W = all_images.shape
            all_poses = np.asarray(data["poses"])
            all_bboxes = data.get("bbox")
            all_focals = np.asarray(data["focal"])
            all_c = np.asarray(data["c"]) if "c" in data else None

            if self.use_bbox and global_step >= self.args.no_bbox_step:
                self.use_bbox = False
                print(">>> Stopped using bbox sampling @ iter", global_step)
            if not is_train or not self.use_bbox:
                all_bboxes = None

            curr_nviews = self.nviews[
                int(self._rng.integers(0, len(self.nviews)))
            ]
            image_ord = np.empty((SB, curr_nviews), dtype=np.int64)

            all_rgb_gt, all_rays = [], []
            for obj_idx in range(SB):
                images = all_images[obj_idx]
                c = all_c[obj_idx] if all_c is not None else None
                image_ord[obj_idx] = self._rng.choice(NV, curr_nviews,
                                                      replace=False)
                if all_bboxes is not None:
                    view, row, col = bbox_sample(
                        np.asarray(all_bboxes[obj_idx]),
                        self.args.ray_batch_size, rng=self._rng).T
                else:
                    pix_inds = self._rng.integers(
                        0, NV * H * W, size=self.args.ray_batch_size)
                    view, row, col = (pix_inds // (H * W),
                                      pix_inds % (H * W) // W, pix_inds % W)
                all_rgb_gt.append(images[view, :, row, col] * 0.5 + 0.5)
                all_rays.append(camera.gen_rays_at_np(
                    all_poses[obj_idx], view, row, col, W, H,
                    all_focals[obj_idx], self.z_near, self.z_far, c=c))

            rays = np.stack(all_rays)  # (SB, R, 8)
            rgb_gt = np.stack(all_rgb_gt)  # (SB, R, 3)
            count("assemble_rays", rays.shape[0] * rays.shape[1])
            src_images = all_images[np.arange(SB)[:, None], image_ord]
            src_poses = all_poses[np.arange(SB)[:, None], image_ord]
            # pad to the mesh's ray multiple with rays of weight 0 (one device
            # pads none), the indices wrapped when the pad outnumbers the rays
            w = np.ones(rays.shape[:2], dtype=np.float32)
            pad_r = (-rays.shape[1]) % self._ray_multiple(SB)
            if pad_r:
                idx = np.arange(pad_r) % rays.shape[1]
                rays = np.concatenate([rays, rays[:, idx]], axis=1)
                rgb_gt = np.concatenate([rgb_gt, rgb_gt[:, idx]], axis=1)
                w = np.concatenate(
                    [w, np.zeros((SB, pad_r), np.float32)], axis=1)
            return src_images, src_poses, all_focals, all_c, rays, rgb_gt, w

    # -- losses and the update -----------------------------------------------

    def compute_losses(self, src_images, src_poses, focal, c, rays, rgb_gt,
                       w, train: bool, draws=None):
        """(loss for the gradient, {"rc", "rf", "t"}).  The arrays are
        ``_assemble``'s; draws optional, over SB * R rows.  On a mesh the
        loss is this rank's part and the reported losses the global ones."""
        dev = self.device
        rays = torch.as_tensor(rays, device=dev)
        rgb_gt = torch.as_tensor(rgb_gt, dtype=torch.float32, device=dev)
        w = torch.as_tensor(w, device=dev)
        w_total = None
        scenes, bn_group = slice(None), None
        if self.mesh is not None:
            # this rank's part of the global batch; the global denominator
            scenes, n_sh, i_sh, bn_group = self._shards(rays.shape[0])
            w_total = torch.sum(w)
            L = rays.shape[1] // n_sh
            rays_of = slice(i_sh * L, (i_sh + 1) * L)
            src_images, src_poses, focal = (
                src_images[scenes], src_poses[scenes], focal[scenes])
            c = c[scenes] if c is not None else None
        with synced_batch_norm(bn_group):
            cond = self.model.encode(src_images, src_poses, focal, c=c,
                                     train=train)
        if self.mesh is not None:
            if draws is None:
                draws = self.renderer.batch_draws(
                    *rays.shape[:2], cond, self._gen, dev, train=train,
                    grad_remat=train and torch.is_grad_enabled()
                    and getattr(self.model, "remat", False))
            draws = parallel.shard_draws(draws, rays.shape[:1], rays_of,
                                         scenes, dev)
            rays, rgb_gt, w = (t[scenes, rays_of] for t in (rays, rgb_gt, w))
        out = self.renderer.render(
            self.model, cond, rays, generator=self._gen, draws=draws,
            train=train)
        with scope("nerf_loss"):
            rc = weighted_rgb_loss(self.rgb_coarse_crit,
                                   out["coarse"]["rgb"], rgb_gt, w, w_total)
            loss = rc * self.lambda_coarse
            loss_dict = {"rc": loss}
            if "fine" in out:
                rf = weighted_rgb_loss(self.rgb_fine_crit, out["fine"]["rgb"],
                                       rgb_gt, w, w_total)
                loss = loss + rf * self.lambda_fine
                loss_dict["rf"] = rf * self.lambda_fine
            loss_dict["t"] = loss
        return loss, self.reduce_losses(
            {k: v.detach() for k, v in loss_dict.items()})

    def calc_losses(self, data, is_train=True, global_step=0, draws=None):
        if "images" not in data:
            return {}
        inputs = self._assemble(data, is_train, global_step)
        if not is_train:
            with torch.no_grad():
                return self.compute_losses(*inputs, train=False,
                                           draws=draws)[1]
        self._last_update = (inputs, {"draws": draws})
        total, loss_dict = self.compute_losses(*inputs, train=True,
                                               draws=draws)
        self.backward_and_step(total)
        return loss_dict

    def train_step(self, data, global_step=0, draws=None):
        with scope("train_step"):
            return self.calc_losses(data, is_train=True,
                                    global_step=global_step, draws=draws)

    def eval_step(self, data, global_step=0, draws=None):
        return self.calc_losses(data, is_train=False,
                                global_step=global_step, draws=draws)

    # -- visualization ---------------------------------------------------------

    @torch.no_grad()
    def vis_step(self, data, global_step=None, idx=None, draws=None):
        """Render an unseen view of one scene in full: (the panels, one row
        a pass, {"psnr": dB of the last pass}), or (None, None) when a
        pass renders all-black."""
        if "images" not in data:
            return {}
        batch_idx = (int(self._rng.integers(0, len(data["images"])))
                     if idx is None else idx)
        images = np.asarray(data["images"][batch_idx])  # (NV, 3, H, W)
        poses = np.asarray(data["poses"][batch_idx])
        # keep the (1, 2) shape: a squeezed (2,) DTU focal would read as
        # two per-scene scalars
        focal = np.asarray(data["focal"][batch_idx:batch_idx + 1])
        c = None
        if "c" in data:
            c = np.asarray(data["c"][batch_idx:batch_idx + 1])
        NV, _, H, W = images.shape
        cam_rays = camera.gen_rays(
            torch.as_tensor(poses, device=self.device), W, H,
            torch.as_tensor(focal).squeeze(), self.z_near, self.z_far,
            c=torch.as_tensor(c).squeeze(0) if c is not None else None)
        images_0to1 = images * 0.5 + 0.5

        curr_nviews = self.nviews[int(self._rng.integers(0, len(self.nviews)))]
        views_src = np.sort(self._rng.choice(NV, curr_nviews, replace=False))
        view_dest = int(self._rng.integers(0, NV - curr_nviews))
        for vs in range(curr_nviews):
            view_dest += view_dest >= views_src[vs]

        source_views = (images_0to1[views_src].transpose(0, 2, 3, 1)
                        .reshape(-1, H, W, 3))
        gt = images_0to1[view_dest].transpose(1, 2, 0).reshape(H, W, 3)

        cond = self.model.encode(images[views_src][None],
                                 poses[views_src][None], focal,
                                 c=c)
        test_rays = cam_rays[view_dest].reshape(1, H * W, -1)
        render_dict = RenderParallel(
            self.renderer, self.model, mesh=self.mesh, want_weights=True)(
            cond, test_rays, generator=self._gen, draws=draws)

        def panels(name, tag):
            p = {k: v[0].float().cpu().numpy()
                 for k, v in render_dict[name].items()}
            alpha = p["weights"].sum(-1).reshape(H, W)
            rgb = p["rgb"].reshape(H, W, 3)
            depth = p["depth"].reshape(H, W)
            print(f"{tag} rgb min {rgb.min()} max {rgb.max()}")
            if rgb.min() == 0 and rgb.max() == 0:
                print(f"{name} rgb is all 0")
                return None, rgb
            return np.hstack([*source_views, gt, cmap(depth)[..., ::-1] / 255,
                              rgb, cmap(alpha)[..., ::-1] / 255]), rgb

        vis, rgb_psnr = panels("coarse", "c")
        if vis is None:
            return None, None
        if "fine" in render_dict:
            vis_fine, rgb_psnr = panels("fine", "f")
            if vis_fine is None:
                return None, None
            vis = np.vstack((vis, vis_fine))

        psnr = psnr_fn(rgb_psnr, gt)
        print("psnr", psnr)
        return vis, {"psnr": psnr}

    def metric_step(self, data_loader, print_hc=False):
        return None, None, None
