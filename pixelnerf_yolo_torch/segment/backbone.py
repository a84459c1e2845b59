"""ResNet-50 (FrozenBN, caffe style) + FPN feature pyramid, inference only.

Counterpart of pixelnerf_yolo_tpu/segment/backbone.py (detectron2's
``build_resnet_fpn_backbone`` as PointRend's configs set it up):

* MSRA/caffe R-50: the stride sits in the FIRST 1x1 conv of each
  bottleneck; FrozenBatchNorm (running statistics folded, eps 1e-5).
* FPN: 1x1 lateral convs to 256 channels, top-down nearest 2x upsample +
  add, 3x3 output convs -> p2..p5; p6 = the stride-2 subsample of p5
  (detectron2's LastLevelMaxPool, max_pool2d with kernel 1, stride 2).

NCHW / OIHW, the params tree of ``port.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# (n_blocks, bottleneck_width, out_channels) per stage, ResNet-50
R50_STAGES = ((3, 64, 256), (4, 128, 512), (6, 256, 1024), (3, 512, 2048))


def conv(x, w, b=None, stride=1, padding=0):
    return F.conv2d(x, w, b, stride, padding)


def frozen_bn(x, p, eps=1e-5):
    """FrozenBatchNorm2d: the running statistics are constants."""
    scale = p["weight"] / torch.sqrt(p["running_var"] + eps)
    shift = p["bias"] - p["running_mean"] * scale
    return x * scale[None, :, None, None] + shift[None, :, None, None]


def _conv_bn(x, p, stride=1, padding=0):
    return frozen_bn(conv(x, p["weight"], stride=stride, padding=padding),
                     p["norm"])


def _bottleneck(x, p, stride):
    """conv1 1x1 (with the stride, caffe style) -> conv2 3x3 -> conv3 1x1;
    a projection shortcut where the block has one."""
    out = torch.relu(_conv_bn(x, p["conv1"], stride=stride))
    out = torch.relu(_conv_bn(out, p["conv2"], stride=1, padding=1))
    out = _conv_bn(out, p["conv3"])
    sc = _conv_bn(x, p["shortcut"], stride=stride) if "shortcut" in p else x
    return torch.relu(out + sc)


def resnet50_features(params, x):
    """x (B, 3, H, W) normalized BGR -> [res2, res3, res4, res5]."""
    x = torch.relu(_conv_bn(x, params["stem"]["conv1"], stride=2,
                            padding=3))
    x = F.max_pool2d(x, 3, 2, 1)
    feats = []
    for i, (n_blocks, _, _) in enumerate(R50_STAGES):
        stage = params[f"res{i + 2}"]
        for j in range(n_blocks):
            first_stride = 1 if i == 0 else 2
            x = _bottleneck(x, stage[str(j)],
                            stride=first_stride if j == 0 else 1)
        feats.append(x)
    return feats


def fpn(params, feats):
    """[res2..res5] -> {p2..p6} 256-channel pyramid."""
    laterals = [conv(f, params[f"fpn_lateral{i + 2}"]["weight"],
                     params[f"fpn_lateral{i + 2}"]["bias"])
                for i, f in enumerate(feats)]
    merged = [laterals[-1]]
    for lat in laterals[-2::-1]:
        up = merged[-1].repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        merged.append(lat + up[:, :, :lat.shape[2], :lat.shape[3]])
    merged = merged[::-1]  # [m2, m3, m4, m5]
    out = {f"p{i + 2}": conv(m, params[f"fpn_output{i + 2}"]["weight"],
                             params[f"fpn_output{i + 2}"]["bias"], padding=1)
           for i, m in enumerate(merged)}
    out["p6"] = out["p5"][:, :, ::2, ::2]  # max_pool2d(kernel=1, stride=2)
    return out


def backbone_apply(params, x):
    return fpn(params["fpn"], resnet50_features(params["bottom_up"], x))
