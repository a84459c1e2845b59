"""Train-time color jitter wrapper (same jitter for all views of a scene).

Counterpart of pixelnerf_yolo_tpu/data/color_jitter.py: torchvision's
functional_tensor adjustments in numpy, in the order saturation -> hue ->
contrast -> brightness on [0,1] images, with the dataset's [-1,1] images
rescaled around it.
"""

from __future__ import annotations

import numpy as np


def _blend(img1: np.ndarray, img2, ratio: float) -> np.ndarray:
    return np.clip(ratio * img1 + (1.0 - ratio) * img2, 0.0, 1.0)


def _grayscale(img: np.ndarray) -> np.ndarray:
    """(C, H, W) -> (1, H, W), ITU-R 601 weights (torchvision)."""
    r, g, b = img[0], img[1], img[2]
    return (0.2989 * r + 0.587 * g + 0.114 * b)[None]


def adjust_brightness(img, factor):
    return _blend(img, 0.0, factor)


def adjust_contrast(img, factor):
    mean = _grayscale(img).mean()
    return _blend(img, mean, factor)


def adjust_saturation(img, factor):
    return _blend(img, _grayscale(img), factor)


def _rgb_to_hsv(img):
    r, g, b = img[0], img[1], img[2]
    maxc = np.maximum(np.maximum(r, g), b)
    minc = np.minimum(np.minimum(r, g), b)
    eqc = maxc == minc
    cr = maxc - minc
    ones = np.ones_like(r)
    s = cr / np.where(eqc, ones, maxc)
    cr_divisor = np.where(eqc, ones, cr)
    rc = (maxc - r) / cr_divisor
    gc = (maxc - g) / cr_divisor
    bc = (maxc - b) / cr_divisor

    hr = (maxc == r) * (bc - gc)
    hg = ((maxc == g) & (maxc != r)) * (2.0 + rc - bc)
    hb = ((maxc != g) & (maxc != r)) * (4.0 + gc - rc)
    h = hr + hg + hb
    h = (h / 6.0 + 1.0) % 1.0
    return np.stack([h, s, maxc])


def _hsv_to_rgb(img):
    h, s, v = img[0], img[1], img[2]
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    i = i.astype(np.int32) % 6
    p = np.clip(v * (1.0 - s), 0.0, 1.0)
    q = np.clip(v * (1.0 - s * f), 0.0, 1.0)
    t = np.clip(v * (1.0 - s * (1.0 - f)), 0.0, 1.0)

    mask = i[None] == np.arange(6)[:, None, None]
    a1 = np.stack([v, q, p, p, t, v])
    a2 = np.stack([t, v, v, q, p, p])
    a3 = np.stack([p, p, t, v, v, q])
    r = (mask * a1).sum(0)
    g = (mask * a2).sum(0)
    b = (mask * a3).sum(0)
    return np.stack([r, g, b])


def adjust_hue(img, factor):
    hsv = _rgb_to_hsv(np.clip(img, 0.0, 1.0))
    hsv[0] = (hsv[0] + factor) % 1.0
    return _hsv_to_rgb(hsv)


class ColorJitterDataset:
    def __init__(
        self,
        base_dset,
        hue_range=0.1,
        saturation_range=0.1,
        brightness_range=0.1,
        contrast_range=0.1,
        extra_inherit_attrs=(),
        rng=None,
    ):
        print("Using color jitter dataset")
        self.hue_range = [-hue_range, hue_range]
        self.saturation_range = [1 - saturation_range, 1 + saturation_range]
        self.brightness_range = [1 - brightness_range, 1 + brightness_range]
        self.contrast_range = [1 - contrast_range, 1 + contrast_range]
        inherit_attrs = ["z_near", "z_far", "base_path", "image_to_tensor"]
        inherit_attrs.extend(extra_inherit_attrs)

        self.base_dset = base_dset
        for attr in inherit_attrs:
            setattr(self, attr, getattr(base_dset, attr))
        self._rng = rng if rng is not None else np.random.default_rng()
        # numpy Generators are not thread-safe; loader prefetch threads
        # (data/loader.py num_workers) draw jitter params under this lock
        import threading

        self._rng_lock = threading.Lock()

    def apply_color_jitter(self, images: np.ndarray) -> np.ndarray:
        with self._rng_lock:
            hue_factor = self._rng.uniform(*self.hue_range)
            saturation_factor = self._rng.uniform(*self.saturation_range)
            brightness_factor = self._rng.uniform(*self.brightness_range)
            contrast_factor = self._rng.uniform(*self.contrast_range)
        out = np.array(images)
        for i in range(len(out)):
            tmp = (out[i] + 1.0) * 0.5
            tmp = adjust_saturation(tmp, saturation_factor)
            tmp = adjust_hue(tmp, hue_factor)
            tmp = adjust_contrast(tmp, contrast_factor)
            tmp = adjust_brightness(tmp, brightness_factor)
            out[i] = tmp * 2.0 - 1.0
        return out

    def __len__(self):
        return len(self.base_dset)

    def __getitem__(self, idx):
        data = self.base_dset[idx]
        data["images"] = self.apply_color_jitter(data["images"])
        return data
