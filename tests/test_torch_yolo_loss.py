"""The port's ``YoloLoss`` against the JAX package's on the CPU: the five
returned values and the gradient of the total with respect to the
prediction, on random predictions and grid targets with object,
no-object and ignore (-1) cells, and on targets whose object or no-object
mask is empty (that term is 0 and passes no gradient)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pixelnerf_yolo_tpu.losses.yolo import YoloLoss as JYoloLoss
from pixelnerf_yolo_torch.config.hocon import parse_string
from pixelnerf_yolo_torch.losses.yolo import YoloLoss

A = 3
ANCHORS = np.array([[0.02, 0.03], [0.04, 0.07], [0.08, 0.06]], np.float32)
WEIGHTS = (1.0, 20.0, 1.0, 1.0)  # box, object, no-object, class
# f32 on both sides; the same operations in the same order but for the
# reductions' summation order
VALUE_RTOL, GRAD_TOL = 1e-6, 1e-6


def _case(rng, shape, kind):
    """pred (*shape, A, 7) with the prob in (0, 1) as the renderer gives
    it; targets (*shape, A, 6) [prob, x, y, w, h, cls]."""
    pred = rng.normal(size=shape + (A, 7)).astype(np.float32)
    pred[..., 0] = rng.uniform(0.01, 0.99, size=shape + (A,))
    tgt = np.zeros(shape + (A, 6), np.float32)
    tgt[..., 1:3] = rng.uniform(0, 1, size=shape + (A, 2))
    tgt[..., 3:5] = rng.uniform(0.01, 3.0, size=shape + (A, 2))
    tgt[..., 5] = rng.integers(0, 2, size=shape + (A,))
    draw = rng.uniform(size=shape + (A,))
    if kind == "mixed":
        tgt[..., 0] = np.where(draw < 0.2, 1.0, np.where(draw < 0.3, -1.0,
                                                         0.0))
    elif kind == "no_objects":
        tgt[..., 0] = np.where(draw < 0.3, -1.0, 0.0)
    elif kind == "only_objects":
        tgt[..., 0] = np.where(draw < 0.5, 1.0, -1.0)
    else:  # every cell ignored: every term 0
        tgt[..., 0] = -1.0
    return pred, tgt


@pytest.mark.parametrize("kind", ["mixed", "no_objects", "only_objects",
                                  "all_ignored"])
@pytest.mark.parametrize("shape", [(64,), (2, 4, 4)], ids=["rays", "grid"])
def test_yolo_loss_matches_jax(rng, shape, kind):
    pred, tgt = _case(rng, shape, kind)
    jl = JYoloLoss(A, *WEIGHTS)
    tl = YoloLoss(A, *WEIGHTS)

    ref = [float(v) for v in jl(jnp.asarray(pred), jnp.asarray(tgt),
                                jnp.asarray(ANCHORS))]
    ref_g = np.asarray(jax.grad(lambda p: jl(p, jnp.asarray(tgt),
                                             jnp.asarray(ANCHORS))[0])(
        jnp.asarray(pred)))

    p = torch.from_numpy(pred).requires_grad_(True)
    got = tl(p, torch.from_numpy(tgt), torch.from_numpy(ANCHORS))
    got[0].backward()
    np.testing.assert_allclose([float(v.detach()) for v in got], ref,
                               rtol=VALUE_RTOL, atol=0)
    g = p.grad.numpy()
    assert np.isfinite(g).all()
    scale = max(np.abs(ref_g).max(), 1e-30)
    assert np.abs(g - ref_g).max() <= GRAD_TOL * scale
    if kind == "no_objects":
        assert ref[1] == ref[2] == ref[4] == 0.0
        assert not g[..., 1:].any()  # only the prob gets a gradient
    if kind == "only_objects":
        assert ref[3] == 0.0
    if kind == "all_ignored":
        assert ref == [0.0] * 5 and not g.any()


@pytest.mark.parametrize("prob", [0.0, 1.0])
def test_bce_log_clamped(rng, prob):
    """A predicted prob of exactly 0 or 1 on a no-object cell: the BCE's
    logs are clamped at -100, so the no-object term is finite and equals
    the JAX package's.  (Its gradient there is NaN in both packages: the
    clamp passes 0 x the log's infinite derivative.)"""
    pred, tgt = _case(rng, (16,), "mixed")
    tgt[0, 0, 0] = 0.0
    pred[0, 0, 0] = prob
    ref = [float(v) for v in JYoloLoss(A, *WEIGHTS)(
        jnp.asarray(pred), jnp.asarray(tgt), jnp.asarray(ANCHORS))]
    got = YoloLoss(A, *WEIGHTS)(torch.from_numpy(pred), torch.from_numpy(tgt),
                                torch.from_numpy(ANCHORS))
    got = [float(v) for v in got]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=VALUE_RTOL, atol=0)


def test_iou_is_detached(rng):
    """The object term's IoU target passes no gradient: the box values
    (x, y, w, h) of a cell get the box term's gradient only."""
    pred, tgt = _case(rng, (32,), "only_objects")
    box_only = YoloLoss(A, 1.0, 0.0, 0.0, 0.0)
    with_obj = YoloLoss(A, 1.0, 20.0, 0.0, 0.0)
    grads = []
    for loss in (box_only, with_obj):
        p = torch.from_numpy(pred).requires_grad_(True)
        loss(p, torch.from_numpy(tgt), torch.from_numpy(ANCHORS))[0].backward()
        grads.append(p.grad.numpy())
    np.testing.assert_array_equal(grads[0][..., 1:5], grads[1][..., 1:5])
    assert np.abs(grads[1][..., 0]).max() > 0


def test_from_conf_reads_the_weights():
    conf = parse_string("""yolo { weights { box_loss = 2
                                            object_loss = 20
                                            no_object_loss = 0.5
                                            class_loss = 3 } }""")
    loss = YoloLoss.from_conf(conf, A)
    assert (loss.num_anchors_per_scale, loss.box_loss, loss.object_loss,
            loss.no_object_loss, loss.class_loss) == (A, 2, 20, 0.5, 3)
