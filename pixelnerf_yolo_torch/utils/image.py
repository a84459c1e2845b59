"""Host-side image transforms (numpy, cv2 where a resize needs it).

Counterpart of pixelnerf_yolo_tpu/utils/image.py: images flow to the
device as normalized float32 CHW arrays.  cv2 is an optional import; a
function that needs it raises when it is missing, except ``cmap``, which
falls back to numpy; ``write_png`` needs neither cv2 nor imageio, so a
trainer's visualizations need neither.
"""

from __future__ import annotations

import struct
import zlib

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
    """Apply a HOT colormap to a float image (BGR uint8, as cv2 returns
    it; without cv2 the HOT ramps in numpy)."""
    u8 = image_float_to_uint8(img)
    if cv2 is None:
        x = u8.astype(np.float32) / 255.0
        ramps = [np.clip(4.0 * x - 3.0, 0, 1), np.clip(8 / 3 * x - 1, 0, 1),
                 np.clip(8 / 3 * x, 0, 1)]
        return (np.stack(ramps, axis=-1) * 255).astype(np.uint8)
    if color_map is None:
        color_map = cv2.COLORMAP_HOT
    return cv2.applyColorMap(u8, color_map)


def write_png(path: str, img_u8: np.ndarray) -> None:
    """Write an (H, W, 3) or (H, W) uint8 image as a PNG (8-bit RGB or
    grey, unfiltered rows, one zlib stream): no imageio needed."""
    img = np.ascontiguousarray(img_u8, dtype=np.uint8)
    h, w = img.shape[:2]
    color = 2 if img.ndim == 3 else 0
    raw = b"".join(b"\x00" + row.tobytes() for row in img.reshape(h, -1))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw))
                + chunk(b"IEND", b""))


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
