"""detectron2 PointRend checkpoint -> segment params tree.

Counterpart of pixelnerf_yolo_tpu/segment/port.py.  The published
checkpoint (detectron2://PointRend/InstanceSegmentation/
pointrend_rcnn_R_50_FPN_3x_coco/164955410/model_final_3c3198.pkl) is a flat
``{dotted.name: array}`` dict; the tree nests the dotted names under a few
top-level moves, and every tensor keeps its torch layout (OIHW convs, (out,
in) linears, (out, in, 1) conv1d), which the apply functions consume.
The tree's leaves are f32 CPU tensors; ``PointRendPredictor`` moves them
to its device.
"""

from __future__ import annotations

import numpy as np
import torch

# top-level module remaps: detectron2 prefix -> tree path
_PREFIX_MAP = [
    ("backbone.bottom_up.", ("backbone", "bottom_up")),
    ("backbone.", ("backbone", "fpn")),  # fpn_lateral* / fpn_output*
    ("proposal_generator.rpn_head.", ("rpn_head",)),
    ("roi_heads.box_head.", ("box_head",)),
    ("roi_heads.box_predictor.", ("box_head",)),
    ("roi_heads.mask_coarse_head.", ("roi_heads", "mask_coarse_head")),
    ("roi_heads.mask_point_head.", ("roi_heads", "mask_point_head")),
]
_SKIP = ("pixel_mean", "pixel_std", "anchor_generator")


def port_detectron2_state_dict(sd: dict) -> dict:
    """Flat detectron2 state dict (numpy arrays or tensors) -> tree."""
    params: dict = {}
    for name, value in sd.items():
        if any(s in name for s in _SKIP):
            continue
        for prefix, base in _PREFIX_MAP:
            if name.startswith(prefix):
                rest = name[len(prefix):]
                break
        else:
            continue  # unknown module (e.g. training-only buffers)
        node = params
        path = list(base) + rest.split(".")
        for key in path[:-1]:
            node = node.setdefault(key, {})
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        node[path[-1]] = torch.from_numpy(np.array(value, dtype=np.float32))
    _validate(params)
    return params


def _validate(params: dict) -> None:
    """Fail fast on a truncated or renamed checkpoint."""
    checks = [
        (("backbone", "bottom_up", "stem", "conv1", "weight"),
         (64, 3, 7, 7)),
        (("backbone", "fpn", "fpn_lateral2", "weight"), (256, 256, 1, 1)),
        (("rpn_head", "anchor_deltas", "weight"), (12, 256, 1, 1)),
        (("box_head", "cls_score", "weight"), (81, 1024)),
        (("roi_heads", "mask_coarse_head", "prediction", "weight"),
         (80 * 49, 1024)),
        (("roi_heads", "mask_point_head", "fc1", "weight"),
         (256, 256 + 80, 1)),
    ]
    for path, shape in checks:
        node = params
        for key in path:
            if key not in node:
                raise KeyError(
                    f"ported checkpoint is missing {'.'.join(path)}")
            node = node[key]
        if tuple(node.shape) != shape:
            raise ValueError(f"{'.'.join(path)}: shape {tuple(node.shape)}, "
                             f"expected {shape}")


def tree_to(params: dict, device) -> dict:
    """The tree with every leaf on ``device``."""
    return {k: tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in params.items()}


def random_params(rng: np.random.Generator | None = None,
                  scale: float = 0.05, value_fn=None,
                  return_flat: bool = False) -> dict:
    """Random params with the checkpoint's exact geometry (the stand-in for
    the real weights), drawn from ``rng`` in the JAX package's order, so
    one seed gives both packages the same values.

    value_fn(name, shape) overrides the draw per tensor; return_flat
    returns the flat detectron2-named dict of numpy arrays instead of the
    tree."""
    rng = rng or np.random.default_rng(0)
    sd: dict = {}

    def add(name, *shape):
        sd[name] = (
            np.asarray(value_fn(name, shape), np.float32)
            if value_fn is not None
            else rng.standard_normal(shape).astype(np.float32) * scale
        )

    def add_conv_bn(name, cout, cin, k):
        add(f"{name}.weight", cout, cin, k, k)
        for p in ("weight", "bias", "running_mean"):
            add(f"{name}.norm.{p}", cout)
        rv_name = f"{name}.norm.running_var"
        rv = (
            np.asarray(value_fn(rv_name, (cout,)), np.float32)
            if value_fn is not None
            else rng.standard_normal(cout).astype(np.float32)
        )
        sd[rv_name] = np.abs(rv) + 1.0

    add_conv_bn("backbone.bottom_up.stem.conv1", 64, 3, 7)
    cin = 64
    stages = ((3, 64, 256), (4, 128, 512), (6, 256, 1024), (3, 512, 2048))
    for i, (n, width, cout) in enumerate(stages):
        for j in range(n):
            p = f"backbone.bottom_up.res{i + 2}.{j}"
            block_in = cin if j == 0 else cout
            add_conv_bn(f"{p}.conv1", width, block_in, 1)
            add_conv_bn(f"{p}.conv2", width, width, 3)
            add_conv_bn(f"{p}.conv3", cout, width, 1)
            if j == 0:
                add_conv_bn(f"{p}.shortcut", cout, block_in, 1)
        cin = cout
    for lvl, ch in zip(range(2, 6), (256, 512, 1024, 2048)):
        add(f"backbone.fpn_lateral{lvl}.weight", 256, ch, 1, 1)
        add(f"backbone.fpn_lateral{lvl}.bias", 256)
        add(f"backbone.fpn_output{lvl}.weight", 256, 256, 3, 3)
        add(f"backbone.fpn_output{lvl}.bias", 256)
    add("proposal_generator.rpn_head.conv.weight", 256, 256, 3, 3)
    add("proposal_generator.rpn_head.conv.bias", 256)
    add("proposal_generator.rpn_head.objectness_logits.weight", 3, 256, 1, 1)
    add("proposal_generator.rpn_head.objectness_logits.bias", 3)
    add("proposal_generator.rpn_head.anchor_deltas.weight", 12, 256, 1, 1)
    add("proposal_generator.rpn_head.anchor_deltas.bias", 12)
    add("roi_heads.box_head.fc1.weight", 1024, 256 * 49)
    add("roi_heads.box_head.fc1.bias", 1024)
    add("roi_heads.box_head.fc2.weight", 1024, 1024)
    add("roi_heads.box_head.fc2.bias", 1024)
    add("roi_heads.box_predictor.cls_score.weight", 81, 1024)
    add("roi_heads.box_predictor.cls_score.bias", 81)
    add("roi_heads.box_predictor.bbox_pred.weight", 320, 1024)
    add("roi_heads.box_predictor.bbox_pred.bias", 320)
    m = "roi_heads.mask_coarse_head"
    add(f"{m}.reduce_spatial_dim_conv.weight", 256, 256, 2, 2)
    add(f"{m}.reduce_spatial_dim_conv.bias", 256)
    add(f"{m}.coarse_mask_fc1.weight", 1024, 256 * 49)
    add(f"{m}.coarse_mask_fc1.bias", 1024)
    add(f"{m}.coarse_mask_fc2.weight", 1024, 1024)
    add(f"{m}.coarse_mask_fc2.bias", 1024)
    add(f"{m}.prediction.weight", 80 * 49, 1024)
    add(f"{m}.prediction.bias", 80 * 49)
    p = "roi_heads.mask_point_head"
    add(f"{p}.fc1.weight", 256, 336, 1)
    add(f"{p}.fc1.bias", 256)
    add(f"{p}.fc2.weight", 256, 336, 1)
    add(f"{p}.fc2.bias", 256)
    add(f"{p}.fc3.weight", 256, 336, 1)
    add(f"{p}.fc3.bias", 256)
    add(f"{p}.predictor.weight", 80, 336, 1)
    add(f"{p}.predictor.bias", 80)
    if return_flat:
        return sd
    return port_detectron2_state_dict(sd)
