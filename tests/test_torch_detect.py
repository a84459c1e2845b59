"""The port's detection layer against the JAX package on the CPU: the
device ops of detect/nms.py (decode, padded greedy NMS, TP/FP/FN) against
detect/nms_jax.py exactly, and the copied numpy modules (boxes.py, map.py)
against the JAX package's on the same inputs."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pixelnerf_yolo_tpu import detect as jdet
from pixelnerf_yolo_tpu.losses.yolo import iou_xywh as jiou
from pixelnerf_yolo_torch import detect as tdet
from pixelnerf_yolo_torch.losses.yolo import iou_xywh as tiou

ANCHORS = np.asarray([[0.02, 0.03], [0.04, 0.07], [0.08, 0.06]], np.float32)


def _boxes(rng, n, n_pad=0, ties=True):
    """(n + n_pad, 6) [class, score, x, y, w, h]: clustered boxes (so NMS
    suppresses), a few exact score ties and duplicates, degenerate widths,
    and n_pad padding rows of score 0."""
    centers = rng.uniform(0.2, 0.8, size=(4, 2))
    xy = centers[rng.integers(0, 4, n)] + rng.normal(size=(n, 2)) * 0.03
    wh = rng.uniform(0.05, 0.25, size=(n, 2))
    b = np.concatenate([rng.integers(0, 2, (n, 1)), rng.uniform(0, 1, (n, 1)),
                        xy, wh], axis=1).astype(np.float32)
    if ties:
        b[3, 1] = b[5, 1]
        b[7] = b[2]
        b[9, 4] = 5e-4  # below the w/h validity window
    pad = np.zeros((n_pad, 6), np.float32)
    return np.concatenate([b, pad])


def test_iou_xywh_matches(rng):
    a = _boxes(rng, 30)[:, 2:]
    b = _boxes(rng, 30)[:, 2:]
    np.testing.assert_array_equal(
        tiou(torch.from_numpy(a)[:, None], torch.from_numpy(b)[None]).numpy(),
        np.asarray(jiou(jnp.asarray(a)[:, None], jnp.asarray(b)[None])))


@pytest.mark.parametrize("is_predictions", [True, False])
def test_decode_cells_matches(rng, is_predictions):
    pred = rng.normal(size=(2, 3, 4, 3, 7)).astype(np.float32)
    if not is_predictions:
        pred = pred[..., :6]
        pred[..., 5] = rng.integers(0, 2, size=pred.shape[:-1])
    ref = np.asarray(jdet.decode_cells(jnp.asarray(pred),
                                       jnp.asarray(ANCHORS), is_predictions))
    got = tdet.decode_cells(torch.from_numpy(pred), torch.from_numpy(ANCHORS),
                            is_predictions).numpy()
    assert got.shape == ref.shape == (2, 3 * 4 * 3, 6)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    # the (h, w, a) order and the class argmax are exact
    np.testing.assert_array_equal(got[..., 0], ref[..., 0])
    host = tdet.convert_cells_to_bboxes(pred, ANCHORS, 3, 4, is_predictions)
    np.testing.assert_allclose(np.asarray(host, np.float32), got,
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_out", [8, 64, 33, 256])
def test_nms_padded_matches(seed, max_out):
    rng = np.random.default_rng(seed)
    boxes = _boxes(rng, 40, n_pad=12)
    for iou_t, score_t in [(0.5, 0.3), (0.2, 0.0)]:
        rk, rv = jdet.nms_padded(jnp.asarray(boxes), iou_t, score_t,
                                 max_out=max_out)
        gk, gv = tdet.nms_padded(torch.from_numpy(boxes), iou_t, score_t,
                                 max_out=max_out)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
        np.testing.assert_array_equal(gk.numpy(), np.asarray(rk))
        assert 0 < int(gv.sum()) < 40


@pytest.mark.parametrize("seed", [0, 1])
def test_tp_fp_fn_padded_matches(seed):
    rng = np.random.default_rng(seed)
    target = _boxes(rng, 12, n_pad=8, ties=False)
    target[:, 1] = np.where(target[:, 1] > 0, 1.0, 0.0)
    pred = _boxes(rng, 40, n_pad=8)
    empty = np.zeros_like(target)
    for t, p in [(target, pred), (empty, pred), (target, np.zeros_like(pred)),
                 (empty, np.zeros_like(pred))]:
        ref = jdet.tp_fp_fn_padded(jnp.asarray(t), jnp.asarray(p), 0.75,
                                   0.45, 0.2, max_out=32)
        got = tdet.tp_fp_fn_padded(torch.from_numpy(t), torch.from_numpy(p),
                                   0.75, 0.45, 0.2, max_out=32)
        assert tuple(int(x) for x in got) == tuple(int(x) for x in ref)


def test_host_copies_match(rng):
    """boxes.py and map.py are copies: the same answers on the same boxes,
    the list-NMS quirk included."""
    gt = _boxes(rng, 15, ties=False)
    gt[:, 1] = 1.0
    pred = _boxes(rng, 60)
    gl, pl = gt.tolist(), pred.tolist()
    for iou_t in (0.3, 0.75):
        assert tdet.nms(pl, iou_t, 0.45) == jdet.nms(pl, iou_t, 0.45)
    assert tdet.calculate_tp_fp_fn(gl, pl, 0.75, 0.45, 0.2) \
        == jdet.calculate_tp_fp_fn(gl, pl, 0.75, 0.45, 0.2)
    assert tdet.calculate_precision_recall_f1(5, 2, 3) \
        == jdet.calculate_precision_recall_f1(5, 2, 3)
    assert tdet.map_from_raw_boxes([gl], [pl], 0.5) \
        == jdet.map_from_raw_boxes([gl], [pl], 0.5)
    assert tdet.suppress_cross_scale([pl[:30], pl[30:]], 0.35) \
        == jdet.suppress_cross_scale([pl[:30], pl[30:]], 0.35)


def test_device_nms_against_host_quirk(rng):
    """The padded NMS is standard greedy NMS; the host list NMS skips the
    box after each removed one, so it keeps a superset."""
    boxes = _boxes(rng, 40)
    host, _, _ = tdet.nms(boxes.tolist(), 0.3, 0.2)
    kept, valid = tdet.nms_padded(torch.from_numpy(boxes), 0.3, 0.2)
    dev = kept[valid].tolist()
    assert all(b in host for b in dev) and len(host) >= len(dev)


@pytest.mark.parametrize("empty", ["pred", "target", "both"])
def test_tp_fp_fn_padded_no_rows(empty):
    """A set with no rows at all (a view whose per-scale thresholds keep no
    box): the counts of the same set given as padding rows only.  The JAX
    package's nms_padded raises there (argmax of an empty sequence)."""
    rng = np.random.default_rng(3)
    target = _boxes(rng, 12, n_pad=8, ties=False)
    target[:, 1] = np.where(target[:, 1] > 0, 1.0, 0.0)
    pred = _boxes(rng, 40, n_pad=8)
    t, p = target, pred
    t_pad, p_pad = target, pred
    if empty in ("target", "both"):
        t, t_pad = target[:0], np.zeros_like(target)
    if empty in ("pred", "both"):
        p, p_pad = pred[:0], np.zeros_like(pred)
    got = tdet.tp_fp_fn_padded(torch.from_numpy(t), torch.from_numpy(p),
                               0.75, 0.45, 0.2, max_out=32)
    want = tdet.tp_fp_fn_padded(torch.from_numpy(t_pad),
                                torch.from_numpy(p_pad), 0.75, 0.45, 0.2,
                                max_out=32)
    assert tuple(int(x) for x in got) == tuple(int(x) for x in want)
    with pytest.raises(ValueError, match="empty"):
        jdet.tp_fp_fn_padded(jnp.asarray(t), jnp.asarray(p), 0.75, 0.45,
                             0.2, max_out=32)
