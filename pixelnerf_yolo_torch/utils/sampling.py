"""Host-side pixel samplers (numpy RNG).

Counterpart of pixelnerf_yolo_tpu/utils/sampling.py: they run on the host
during batch assembly and give the pixel indices of a ray batch.  Under
the same ``np.random.Generator`` state they draw the same numbers in the
same order as the JAX package's.
"""

from __future__ import annotations

import numpy as np


def masked_sample(
    masks: np.ndarray,
    num_pix: int,
    prop_inside: float,
    thresh: float = 0.5,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Sample pixel coords (num_pix, 3)=[img, y, x], a fraction inside masks."""
    if rng is None:
        rng = np.random.default_rng()
    num_inside = int(num_pix * prop_inside + 0.5)
    num_outside = num_pix - num_inside
    inside = np.argwhere(masks >= thresh)
    outside = np.argwhere(masks < thresh)
    pix_inside = inside[rng.integers(0, len(inside), size=num_inside)]
    pix_outside = outside[rng.integers(0, len(outside), size=num_outside)]
    return np.concatenate([pix_inside, pix_outside], axis=0)


def bbox_sample(
    bboxes: np.ndarray, num_pix: int, rng: np.random.Generator | None = None
) -> np.ndarray:
    """Sample pixels uniformly inside per-image bboxes (cmin, rmin, cmax, rmax).

    :param bboxes (NV, 4)
    :return (num_pix, 3) = [image_id, y, x]
    """
    if rng is None:
        rng = np.random.default_rng()
    image_ids = rng.integers(0, bboxes.shape[0], size=num_pix)
    pix_bboxes = bboxes[image_ids]
    x = (
        rng.random(num_pix) * (pix_bboxes[:, 2] + 1 - pix_bboxes[:, 0])
        + pix_bboxes[:, 0]
    ).astype(np.int64)
    y = (
        rng.random(num_pix) * (pix_bboxes[:, 3] + 1 - pix_bboxes[:, 1])
        + pix_bboxes[:, 1]
    ).astype(np.int64)
    return np.stack([image_ids, y, x], axis=-1)
