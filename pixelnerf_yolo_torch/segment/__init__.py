"""PointRend instance segmentation, the preprocessing tool's mask source.

Counterpart of pixelnerf_yolo_tpu/segment/: detectron2's PointRend R50-FPN
COCO model at inference (ResNet-50-FrozenBN + FPN backbone, RPN, ROI box
head, PointRend coarse-mask head and point-head subdivision) as torch
functions over a params tree of tensors in detectron2's layouts, with the
ragged parts (anchors, NMS, level grouping) on the host in numpy.  The
weights are ``pointrend_r50fpn.npz`` (``scripts/port_detectron2.py``
writes it from the published checkpoint) on ``nn.pretrained.search_dirs``.

Offline tooling: runs once per photo; clarity over throughput.
"""

from .port import port_detectron2_state_dict, random_params  # noqa: F401
from .predictor import (  # noqa: F401
    PointRendPredictor,
    load_pointrend_params,
    pointrend_npz_path,
)
