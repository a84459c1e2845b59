"""Host-side image transforms (numpy, cv2 where a resize needs it).

Counterpart of pixelnerf_yolo_tpu/utils/image.py: images flow to the
device as normalized float32 CHW arrays.  cv2 is an optional import; a
function that needs it raises when it is missing.
"""

from __future__ import annotations

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def image_float_to_uint8(img: np.ndarray) -> np.ndarray:
    """Min-max normalize a float image to uint8 [0, 255]."""
    vmin = np.min(img)
    vmax = np.max(img)
    if vmax - vmin < 1e-10:
        vmax += 1e-10
    img = (img - vmin) / (vmax - vmin)
    return (img * 255.0).astype(np.uint8)


def cmap(img: np.ndarray, color_map=None) -> np.ndarray:
    """Apply a HOT colormap to a float image."""
    if cv2 is None:
        raise ImportError("cv2 required for cmap")
    if color_map is None:
        color_map = cv2.COLORMAP_HOT
    return cv2.applyColorMap(image_float_to_uint8(img), color_map)


def image_to_tensor_balanced(img: np.ndarray, image_size: int = 0) -> np.ndarray:
    """uint8 HWC [0,255] -> float32 CHW in [-1, 1] (torchvision ToTensor +
    Normalize(0.5, 0.5)), with an optional shorter-side resize."""
    if image_size > 0:
        h, w = img.shape[:2]
        if h < w:
            nh, nw = image_size, int(round(w * image_size / h))
        else:
            nh, nw = int(round(h * image_size / w)), image_size
        if cv2 is None:
            raise ImportError("cv2 required for resize")
        img = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
    img = np.asarray(img, dtype=np.float32) / 255.0
    img = img * 2.0 - 1.0
    return np.ascontiguousarray(img.transpose(2, 0, 1))


def mask_to_tensor(mask: np.ndarray) -> np.ndarray:
    """uint8 HW or HW1 mask [0,255] -> float32 1HW in [0, 1]."""
    if mask.ndim == 3:
        mask = mask[..., 0]
    return (np.asarray(mask, dtype=np.float32) / 255.0)[None]
