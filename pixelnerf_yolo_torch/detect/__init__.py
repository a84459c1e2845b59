"""Detection postprocessing layer: host (numpy) box ops and mAP, and the
padded device NMS in torch."""

# the submodule first: importing it binds the package attribute ``nms`` to
# the module, and the host function of that name below must win
from .nms import decode_cells, nms_padded, tp_fp_fn_padded  # noqa: I001
from .boxes import (
    calculate_precision_recall_f1,
    calculate_tp_fp_fn,
    convert_cells_to_bboxes,
    draw_bounding_boxes,
    iou,
    nms,
    suppress_cross_scale,
)
from .map import (
    average_precision,
    map_from_raw_boxes,
    match_image_detections,
    mean_average_precision,
)

__all__ = [
    "average_precision",
    "calculate_precision_recall_f1",
    "calculate_tp_fp_fn",
    "convert_cells_to_bboxes",
    "decode_cells",
    "draw_bounding_boxes",
    "iou",
    "map_from_raw_boxes",
    "match_image_detections",
    "mean_average_precision",
    "nms",
    "nms_padded",
    "suppress_cross_scale",
    "tp_fp_fn_padded",
]
