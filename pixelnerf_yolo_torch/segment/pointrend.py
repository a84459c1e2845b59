"""PointRend mask heads: the coarse mask and the point-head subdivision.

Counterpart of pixelnerf_yolo_tpu/segment/pointrend.py:

* ``point_sample``: grid_sample over [0, 1]^2 coords, align_corners=False,
  zeros padding;
* the coarse head: 14x14 regular-grid point features from p2, a 2x2
  stride-2 conv, 2 x FC-1024, 80 x 7 x 7 logits;
* the point head: 3 x Conv1d-256 on [fine p2 feature; 80 coarse logits],
  the coarse logits concatenated again after every layer;
* subdivision: 5 steps of 784 points: 2x bilinear upsample, the 784 most
  uncertain grid points (uncertainty -|logit of the predicted class|)
  re-predicted by the point head and scattered back;
* ``paste_masks``: the box masks sampled at the image's pixel centres.

The instance count R stays a host-side dimension; the array work is torch
on the features' device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.grid_sample import grid_sample_nhwc
from ..ops.resize import resize_bilinear
from .backbone import conv
from .rcnn import STRIDES_RPN

COARSE_SIDE = 14  # ROI_MASK_HEAD.POOLER_RESOLUTION
COARSE_OUT = 7  # ROI_MASK_HEAD.OUTPUT_SIDE_RESOLUTION
NUM_CLASSES = 80
SUBDIV_STEPS = 5  # POINT_HEAD.SUBDIVISION_STEPS
SUBDIV_POINTS = 28 * 28  # POINT_HEAD.SUBDIVISION_NUM_POINTS


def point_sample(feat: torch.Tensor, coords01: torch.Tensor) -> torch.Tensor:
    """Sample (N, C, H, W) at (N, P, 2) coords in [0, 1]^2 -> (N, C, P)."""
    N, C, H, W = feat.shape
    flat = feat.reshape(N, C, H * W).transpose(1, 2)
    out = grid_sample_nhwc(flat, 2.0 * coords01 - 1.0, H, W,
                           padding_mode="zeros", align_corners=False)
    return out.transpose(1, 2)


def regular_grid_coords(side: int) -> np.ndarray:
    """(side^2, 2) xy grid at the cell centres (i + 0.5) / side, y outer."""
    c = (np.arange(side, dtype=np.float32) + 0.5) / side
    gx, gy = np.meshgrid(c, c)
    return np.stack([gx.ravel(), gy.ravel()], axis=1)


def sample_box_features(feat: torch.Tensor, boxes: np.ndarray,
                        coords01: torch.Tensor, stride: int) -> torch.Tensor:
    """point_sample_fine_grained_features for one level and image: every
    box's points gathered from the one shared (1, H*W, C) table.

    :param feat (1, C, Hf, Wf); boxes (R, 4) xyxy image coords;
      coords01 (R, P, 2) or (P, 2) box-normalized
    :return (R, C, P)
    """
    R = len(boxes)
    b = torch.as_tensor(boxes, dtype=torch.float32, device=feat.device)
    if coords01.ndim == 2:
        coords01 = coords01[None].expand((R,) + tuple(coords01.shape))
    P = coords01.shape[1]
    wh = b[:, None, 2:4] - b[:, None, 0:2]  # (R, 1, 2)
    coords_img = b[:, None, 0:2] + coords01 * wh
    _, C, Hf, Wf = feat.shape
    extent = torch.tensor([Wf * stride, Hf * stride], dtype=torch.float32,
                          device=feat.device)
    coords_feat01 = coords_img / extent
    flat = feat.reshape(1, C, Hf * Wf).transpose(1, 2)
    grid = (2.0 * coords_feat01 - 1.0).reshape(1, R * P, 2)
    out = grid_sample_nhwc(flat, grid, Hf, Wf, padding_mode="zeros",
                           align_corners=False)  # (1, R*P, C)
    return out.reshape(R, P, C).transpose(1, 2)


def coarse_mask_head_apply(params, x: torch.Tensor) -> torch.Tensor:
    """(R, 256, 14, 14) regular-grid features -> (R, 80, 7, 7) logits."""
    x = torch.relu(conv(x, params["reduce_spatial_dim_conv"]["weight"],
                        params["reduce_spatial_dim_conv"]["bias"], stride=2))
    x = x.reshape(x.shape[0], -1)
    x = torch.relu(x @ params["coarse_mask_fc1"]["weight"].T
                   + params["coarse_mask_fc1"]["bias"])
    x = torch.relu(x @ params["coarse_mask_fc2"]["weight"].T
                   + params["coarse_mask_fc2"]["bias"])
    x = x @ params["prediction"]["weight"].T + params["prediction"]["bias"]
    return x.reshape(-1, NUM_CLASSES, COARSE_OUT, COARSE_OUT)


def point_head_apply(params, fine: torch.Tensor,
                     coarse: torch.Tensor) -> torch.Tensor:
    """StandardPointHead: (R, C, P) + (R, 80, P) -> (R, 80, P) logits;
    Conv1d(k=1) is a per-point linear map."""
    x = torch.cat([fine, coarse], dim=1)
    for k in (1, 2, 3):
        w = params[f"fc{k}"]["weight"][:, :, 0]
        x = torch.relu(torch.einsum("oi,rip->rop", w, x)
                       + params[f"fc{k}"]["bias"][None, :, None])
        x = torch.cat([x, coarse], dim=1)
    w = params["predictor"]["weight"][:, :, 0]
    return (torch.einsum("oi,rip->rop", w, x)
            + params["predictor"]["bias"][None, :, None])


def _pick(logits: torch.Tensor, classes: np.ndarray) -> torch.Tensor:
    """(R, C, ...) -> (R, 1, ...): each row's channel of its class."""
    idx = torch.as_tensor(np.asarray(classes), device=logits.device)
    idx = idx.reshape((-1,) + (1,) * (logits.ndim - 1))
    return torch.gather(logits, 1, idx.expand((-1, 1) + logits.shape[2:]))


def uncertainty(logits: torch.Tensor, classes: np.ndarray) -> torch.Tensor:
    """-|logit of the predicted class|: (R, C, ...) -> (R, 1, ...)."""
    return -torch.abs(_pick(logits, classes))


def uncertain_grid_points(unc_map: torch.Tensor, num_points: int):
    """The top-``num_points`` uncertain cells of an (R, 1, H, W) map ->
    (indices (R, P), coords (R, P, 2) at the cell centres in [0, 1])."""
    R, _, H, W = unc_map.shape
    num_points = min(H * W, num_points)
    idx = torch.topk(unc_map.reshape(R, H * W), num_points, dim=1).indices
    xs = (idx % W).float()
    ys = torch.div(idx, W, rounding_mode="floor").float()
    return idx, torch.stack([(xs + 0.5) / W, (ys + 0.5) / H], dim=-1)


def mask_point_inference(params, p2: torch.Tensor, boxes: np.ndarray,
                         classes: np.ndarray) -> torch.Tensor:
    """PointRend mask inference: (R, 1, 224, 224) sigmoid masks (coarse
    7x7 logits, then SUBDIV_STEPS x (2x upsample, the SUBDIV_POINTS most
    uncertain points re-predicted by the point head))."""
    R = len(boxes)
    stride = STRIDES_RPN["p2"]
    grid14 = torch.from_numpy(regular_grid_coords(COARSE_SIDE)).to(p2.device)
    coarse_feats = sample_box_features(p2, boxes, grid14, stride)
    coarse_logits = coarse_mask_head_apply(
        params["mask_coarse_head"],
        coarse_feats.reshape(R, -1, COARSE_SIDE, COARSE_SIDE))

    mask_logits = coarse_logits
    for step in range(SUBDIV_STEPS):
        H, W = mask_logits.shape[-2:]
        mask_logits = resize_bilinear(mask_logits, (H * 2, W * 2),
                                      align_corners=False)
        H, W = H * 2, W * 2
        if SUBDIV_POINTS >= 4 * H * W and step < SUBDIV_STEPS - 1:
            continue  # the next resolution's refinement covers this one
        idx, coords = uncertain_grid_points(
            uncertainty(mask_logits, classes), SUBDIV_POINTS)
        fine = sample_box_features(p2, boxes, coords, stride)
        coarse_at = point_sample(coarse_logits, coords)
        point_logits = point_head_apply(params["mask_point_head"], fine,
                                        coarse_at)  # (R, 80, P)
        flat = mask_logits.reshape(R, NUM_CLASSES, H * W).clone()
        flat.scatter_(2, idx[:, None, :].expand(-1, NUM_CLASSES, -1),
                      point_logits)
        mask_logits = flat.reshape(R, NUM_CLASSES, H, W)
    return torch.sigmoid(_pick(mask_logits, classes))


def paste_masks(masks: torch.Tensor, boxes: np.ndarray, img_h: int,
                img_w: int, thresh: float = 0.5) -> np.ndarray:
    """Paste (R, 1, M, M) box masks into full-image binary masks
    (detectron2 _do_paste_mask: the box mask sampled at the image's pixel
    centres with align_corners=False).

    :return (R, img_h, img_w) uint8 in {0, 1}
    """
    R = masks.shape[0]
    if R == 0:
        return np.zeros((0, img_h, img_w), np.uint8)
    dev = masks.device
    b = torch.as_tensor(boxes, dtype=torch.float32, device=dev)
    xs = torch.arange(img_w, dtype=torch.float32, device=dev) + 0.5
    ys = torch.arange(img_h, dtype=torch.float32, device=dev) + 0.5
    w = torch.clamp(b[:, 2] - b[:, 0], min=1e-6)
    h = torch.clamp(b[:, 3] - b[:, 1], min=1e-6)
    gx = (xs[None, :] - b[:, 0:1]) / w[:, None] * 2.0 - 1.0  # (R, W)
    gy = (ys[None, :] - b[:, 1:2]) / h[:, None] * 2.0 - 1.0  # (R, H)
    grid = torch.stack([gx[:, None, :].expand(R, img_h, img_w),
                        gy[:, :, None].expand(R, img_h, img_w)],
                       dim=-1).reshape(R, img_h * img_w, 2)
    M = masks.shape[-1]
    flat = masks.reshape(R, 1, M * M).transpose(1, 2)
    out = grid_sample_nhwc(flat, grid, M, M, padding_mode="zeros",
                           align_corners=False).reshape(R, img_h, img_w)
    return (out >= thresh).to(torch.uint8).cpu().numpy()
