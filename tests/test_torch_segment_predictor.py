"""The whole PointRend predictor of the port (pixelnerf_yolo_torch/segment)
against the JAX package's on the CPU, with the same
``random_params(default_rng(0))`` weights, at min_size 64 / max_size 96:
the same detections (boxes within 1e-3 px, the same classes, scores to
1e-5 relative, masks equal on all but 0.1% of pixels)."""

import numpy as np
import pytest

from pixelnerf_yolo_tpu.segment import port as jport
from pixelnerf_yolo_tpu.segment import rcnn as jrcnn
from pixelnerf_yolo_tpu.segment.predictor import (
    PointRendPredictor as JPredictor)
from pixelnerf_yolo_torch.segment import PointRendPredictor, port, rcnn
from test_torch_segment import _close
from torch_parity import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def params():
    return (jport.random_params(np.random.default_rng(0)),
            port.random_params(np.random.default_rng(0)))


def test_predictor_matches_jax(params, monkeypatch):
    """Detection of a seeded photo: the same detections.  Both predictors
    keep their 8 best (``box_inference``'s topk, 100 by default), which
    keeps the point head's work small."""
    import functools

    import pixelnerf_yolo_tpu.segment.predictor as jpredictor
    import pixelnerf_yolo_torch.segment.predictor as tpredictor

    for mod, fn in ((jpredictor, jrcnn.box_inference),
                    (tpredictor, rcnn.box_inference)):
        monkeypatch.setattr(mod, "box_inference",
                            functools.partial(fn, topk=8))
    jp, tp = params
    img = (np.random.default_rng(7).random((48, 64, 3)) * 255).astype(
        np.uint8)
    kw = dict(score_thresh=0.0, min_size=64, max_size=96)
    ref = JPredictor(params=jp, **kw).detect(img)
    assert len(ref["boxes"]) == 8
    pred = PointRendPredictor(params=tp, device="cpu", **kw)
    got = pred.detect(img)
    assert len(got["boxes"]) == len(ref["boxes"]) > 0
    np.testing.assert_array_equal(got["classes"], ref["classes"])
    assert np.abs(got["boxes"] - ref["boxes"]).max() <= 1e-3
    _close(got["scores"], ref["scores"])
    assert got["masks"].shape == ref["masks"].shape == (len(ref["boxes"]),
                                                        48, 64)
    assert (got["masks"] != ref["masks"]).mean() <= 1e-3
    masks = pred.segment(img)
    assert len(masks) == len(ref["boxes"])
    assert all(m.dtype == np.uint8 and set(np.unique(m)) <= {0, 255}
               for m in masks)
