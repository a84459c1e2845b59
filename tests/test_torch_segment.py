"""The port's PointRend predictor (pixelnerf_yolo_torch/segment) against
the JAX package's (pixelnerf_yolo_tpu/segment) on the CPU, with the same
``random_params(default_rng(0))`` weights and numpy-seeded inputs: the
host code (anchors, box deltas, clipping, NMS, level assignment) exactly,
each array stage to 1e-5 relative, and the preprocessing CLI; the whole
predictor in tests/test_torch_segment_predictor.py."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pixelnerf_yolo_tpu.segment import backbone as jbackbone
from pixelnerf_yolo_tpu.segment import pointrend as jpointrend
from pixelnerf_yolo_tpu.segment import port as jport
from pixelnerf_yolo_tpu.segment import rcnn as jrcnn
from pixelnerf_yolo_torch.segment import (PointRendPredictor, backbone,
                                          pointrend, port, rcnn)
from torch_parity import one_torch_thread  # noqa: F401

REL_TOL = 1e-5


def _close(got, ref, rel=REL_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=rel * max(1.0, np.abs(ref).max()))


@pytest.fixture(scope="module")
def params():
    return (jport.random_params(np.random.default_rng(0)),
            port.random_params(np.random.default_rng(0)))


@pytest.fixture(scope="module")
def feats(params):
    """Both packages' FPN features of one seeded input."""
    jp, tp = params
    x = np.random.default_rng(2).normal(size=(1, 3, 64, 128)).astype(
        np.float32) * 50
    ref = jbackbone.backbone_apply(jp["backbone"], jnp.asarray(x))
    got = backbone.backbone_apply(tp["backbone"], torch.from_numpy(x))
    return ref, got


def test_random_params_identical(params):
    """One seed gives both packages the same tensors under the same
    paths; the flat form is the detectron2-named dict."""
    jp, tp = params

    def flat(t, pre=""):
        out = {}
        for k, v in t.items():
            out.update(flat(v, f"{pre}/{k}") if isinstance(v, dict)
                       else {f"{pre}/{k}": v})
        return out

    jf, tf = flat(jp), flat(tp)
    assert jf.keys() == tf.keys()
    for k in jf:
        np.testing.assert_array_equal(tf[k].numpy(), np.asarray(jf[k]))
    sd = port.random_params(np.random.default_rng(0), return_flat=True)
    assert set(sd) == set(jport.random_params(np.random.default_rng(0),
                                              return_flat=True))


def test_port_rejects_missing_key():
    sd = {"backbone.bottom_up.stem.conv1.weight": np.zeros((64, 3, 7, 7),
                                                           np.float32)}
    with pytest.raises(KeyError):
        port.port_detectron2_state_dict(sd)


# -- host code: exact -------------------------------------------------------

def test_host_box_code_exact(rng):
    for size in (32.0, 100.0):
        np.testing.assert_array_equal(rcnn.cell_anchors(size),
                                      jrcnn.cell_anchors(size))
    np.testing.assert_array_equal(rcnn.grid_anchors(3, 5, 8, 64.0),
                                  jrcnn.grid_anchors(3, 5, 8, 64.0))
    boxes = np.sort(rng.random((20, 2, 2)) * 50, axis=1).reshape(20, 4)
    boxes = boxes[:, [0, 2, 1, 3]].astype(np.float32)
    deltas = rng.normal(size=(20, 3, 4)).astype(np.float32)
    for d, w in ((deltas[:, 0], (1.0, 1.0, 1.0, 1.0)),
                 (deltas, (10.0, 10.0, 5.0, 5.0))):
        np.testing.assert_array_equal(rcnn.apply_deltas(d, boxes, w),
                                      jrcnn.apply_deltas(d, boxes, w))
    np.testing.assert_array_equal(rcnn.clip_boxes(boxes * 2, 40, 60),
                                  jrcnn.clip_boxes(boxes * 2, 40, 60))
    scores = rng.random(20).astype(np.float32)
    ids = rng.integers(0, 3, 20)
    np.testing.assert_array_equal(rcnn.nms_xyxy(boxes, scores, 0.3),
                                  jrcnn.nms_xyxy(boxes, scores, 0.3))
    np.testing.assert_array_equal(rcnn.batched_nms(boxes, scores, ids, 0.3),
                                  jrcnn.batched_nms(boxes, scores, ids, 0.3))
    big = np.concatenate([boxes, boxes * 10, boxes / 10])
    np.testing.assert_array_equal(rcnn.assign_levels(big),
                                  jrcnn.assign_levels(big))


# -- array stages: 1e-5 relative ----------------------------------------------

def test_backbone_pyramid(feats):
    ref, got = feats
    assert set(got) == set(ref) == {"p2", "p3", "p4", "p5", "p6"}
    for k in ref:
        _close(got[k], ref[k])
    assert got["p2"].shape == (1, 256, 16, 32)


def test_frozen_bn(rng):
    x = rng.normal(size=(1, 4, 3, 3)).astype(np.float32)
    p = {k: rng.random(4).astype(np.float32) + 0.5
         for k in ("weight", "bias", "running_mean", "running_var")}
    _close(backbone.frozen_bn(torch.from_numpy(x),
                              {k: torch.from_numpy(v) for k, v in p.items()}),
           jbackbone.frozen_bn(jnp.asarray(x), p))


def test_rpn_and_proposals(params, feats):
    jp, tp = params
    ref_f, got_f = feats
    ref = jrcnn.rpn_head_apply(jp["rpn_head"], ref_f)
    got = rcnn.rpn_head_apply(tp["rpn_head"], got_f)
    for k in ref:
        for a, b in zip(got[k], ref[k]):
            _close(a, b)
    rb, rs = jrcnn.rpn_proposals(ref, 64, 128)
    gb, gs = rcnn.rpn_proposals(got, 64, 128)
    # the same proposals; scores that tie to rounding may swap places
    assert len(gb) == len(rb) > 0
    dist = np.abs(gb[:, None, :] - rb[None, :, :]).max(-1)
    assert dist.min(1).max() <= REL_TOL * np.abs(rb).max()
    assert dist.min(0).max() <= REL_TOL * np.abs(rb).max()
    _close(np.sort(gs), np.sort(rs))


@pytest.mark.parametrize("level", [2, 3])
def test_roi_align_and_pooler(feats, rng, level):
    ref_f, got_f = feats
    boxes = np.array([[3.0, 4.0, 40.0, 30.0], [10.5, 2.0, 120.0, 60.0],
                      [0.0, 0.0, 6.0, 5.0]], np.float32)
    scale = 1.0 / rcnn.STRIDES_RPN[f"p{level}"]
    _close(rcnn.roi_align(got_f[f"p{level}"], boxes, 7, scale),
           jrcnn.roi_align(ref_f[f"p{level}"], boxes, 7, scale))
    _close(rcnn.pool_roi_features(got_f, boxes),
           jrcnn.pool_roi_features(ref_f, boxes))


def test_box_head_and_inference(params, rng):
    jp, tp = params
    pooled = rng.normal(size=(6, 256, 7, 7)).astype(np.float32)
    rs, rd = jrcnn.box_head_apply(jp["box_head"], jnp.asarray(pooled))
    gs, gd = rcnn.box_head_apply(tp["box_head"], torch.from_numpy(pooled))
    _close(gs, rs)
    _close(gd, rd)
    proposals = np.array([[2, 3, 30, 40], [10, 10, 50, 60], [0, 0, 20, 20],
                          [5, 5, 60, 30], [1, 2, 3, 4], [20, 0, 64, 64]],
                         np.float32)
    ref = jrcnn.box_inference(np.asarray(rs), np.asarray(rd), proposals, 64,
                              64, score_thresh=0.0)
    got = rcnn.box_inference(gs, gd.numpy(), proposals, 64, 64,
                             score_thresh=0.0)
    np.testing.assert_array_equal(got[2], ref[2])
    _close(got[0], ref[0])
    _close(got[1], ref[1])


def test_point_ops(rng):
    feat = rng.normal(size=(2, 5, 9, 7)).astype(np.float32)
    coords = rng.random((2, 33, 2)).astype(np.float32)
    _close(pointrend.point_sample(torch.from_numpy(feat),
                                  torch.from_numpy(coords)),
           jpointrend.point_sample(jnp.asarray(feat), jnp.asarray(coords)))
    np.testing.assert_array_equal(pointrend.regular_grid_coords(5),
                                  jpointrend.regular_grid_coords(5))
    boxes = np.array([[4.0, 4.0, 20.0, 30.0], [0.0, 8.0, 28.0, 16.0]],
                     np.float32)
    _close(pointrend.sample_box_features(torch.from_numpy(feat[:1]), boxes,
                                         torch.from_numpy(coords), 4),
           jpointrend.sample_box_features(jnp.asarray(feat[:1]), boxes,
                                          jnp.asarray(coords), 4))
    logits = rng.normal(size=(2, 5, 6, 6)).astype(np.float32)
    classes = np.array([1, 3])
    unc = pointrend.uncertainty(torch.from_numpy(logits), classes)
    _close(unc, jpointrend.uncertainty(jnp.asarray(logits), classes))
    gi, gc = pointrend.uncertain_grid_points(unc, 7)
    ri, rc = jpointrend.uncertain_grid_points(jnp.asarray(unc.numpy()), 7)
    np.testing.assert_array_equal(np.sort(gi.numpy(), 1),
                                  np.sort(np.asarray(ri), 1))
    np.testing.assert_array_equal(
        np.sort(gc.numpy().view(np.complex64)[..., 0], 1),
        np.sort(np.asarray(rc).view(np.complex64)[..., 0], 1))


def test_mask_heads(params, rng):
    jp, tp = params
    x = rng.normal(size=(2, 256, 14, 14)).astype(np.float32)
    _close(pointrend.coarse_mask_head_apply(
        tp["roi_heads"]["mask_coarse_head"], torch.from_numpy(x)),
        jpointrend.coarse_mask_head_apply(
            jp["roi_heads"]["mask_coarse_head"], jnp.asarray(x)))
    fine = rng.normal(size=(2, 256, 5)).astype(np.float32)
    coarse = rng.normal(size=(2, 80, 5)).astype(np.float32)
    _close(pointrend.point_head_apply(tp["roi_heads"]["mask_point_head"],
                                      torch.from_numpy(fine),
                                      torch.from_numpy(coarse)),
           jpointrend.point_head_apply(jp["roi_heads"]["mask_point_head"],
                                       jnp.asarray(fine),
                                       jnp.asarray(coarse)))
    p2 = rng.normal(size=(1, 256, 16, 16)).astype(np.float32)
    boxes = np.array([[4.0, 4.0, 40.0, 40.0], [10.0, 0.0, 60.0, 30.0]],
                     np.float32)
    classes = np.array([2, 17])
    got = pointrend.mask_point_inference(tp["roi_heads"],
                                         torch.from_numpy(p2), boxes, classes)
    ref = jpointrend.mask_point_inference(jp["roi_heads"], jnp.asarray(p2),
                                          boxes, classes)
    assert got.shape == (2, 1, 224, 224)
    _close(got, ref)
    img_boxes = boxes * 0.8
    np.testing.assert_array_equal(
        pointrend.paste_masks(got, img_boxes, 40, 50),
        jpointrend.paste_masks(ref, img_boxes, 40, 50))


# -- the preprocessing CLI --------------------------------------------------

def test_preproc_cli(tmp_path, params, rng, monkeypatch):
    """python -m pixelnerf_yolo_torch.preproc on a synthetic photo, with
    the random-weight predictor (no npz here; its 4 best detections) and
    with GrabCut."""
    import functools

    import pixelnerf_yolo_torch.segment.predictor as tpredictor

    cv2 = pytest.importorskip("cv2")
    from pixelnerf_yolo_torch import preproc

    monkeypatch.setattr(tpredictor, "box_inference",
                        functools.partial(rcnn.box_inference, topk=4))
    img = np.full((60, 80, 3), 255, np.uint8)
    img[15:45, 20:60] = (rng.random((30, 40, 3)) * 120).astype(np.uint8)
    path = str(tmp_path / "photo.png")
    cv2.imwrite(path, img)
    pred = PointRendPredictor(params=params[1], device="cpu",
                              score_thresh=0.0, min_size=64, max_size=96,
                              filter_class=-1)
    for seg, kw in (("pointrend", {"predictor": pred}), ("grabcut", {})):
        out = str(tmp_path / seg)
        written = preproc.main([path, "-o", out, "--size", "32", "--seg",
                                seg, "--device", "cpu"], **kw)
        assert written == [str(tmp_path / seg / "photo_normalize.png")]
        res = cv2.imread(written[0])
        assert res.shape == (32, 32, 3)
