"""Multi-scale detection on the device path (``decode_scales``,
``cross_scale_padded``, ``nms_padded``) on the CPU: against the trainer's
host chain (``convert_cells_to_bboxes`` -> ``YOLOTrainer._filter_scales``
-> ``suppress_cross_scale`` -> the list ``nms``) on seeded candidates, the
rays of every grid rendered in one batch against a render of each grid,
and the port against the benchmark's plain reference
(``benchmark/reference/multiscale.py``) at a small width."""

import copy
import types

import numpy as np
import pytest
import torch

from pixelnerf_yolo_torch.detect.boxes import convert_cells_to_bboxes, iou, nms
from pixelnerf_yolo_torch.detect.nms import (cross_scale_padded,
                                             decode_scales, nms_padded)
from pixelnerf_yolo_torch.train.yolo_trainer import YOLOTrainer
from pixelnerf_yolo_torch.utils import profiling
from pixelnerf_yolo_torch.utils.camera import (gen_rays_yolo,
                                               gen_rays_yolo_scales)

THR, NMS_IOU, XIOU = 0.45, 0.75, 0.35
GRIDS = [(2, 2), (4, 4), (8, 8)]
A = 3


def candidates(seed):
    """Per-scale [class, score, x, y, w, h] rows (float32) of GRIDS x A
    cells: background boxes, objects seen at every scale (cross-scale
    duplicates, some of the other class), a same-scale pair above the NMS
    IoU, a box that fails NMS's size bound and removes a box of another
    scale that passes it, and a box whose score passes the threshold but
    not the floor of its scale (0.6 on scale 1) that would remove another.

    Built so that the chains' arithmetic cannot part: no two entering
    scores are equal, no IoU between entering boxes lies within 1e-6 of
    0.35 or 0.75, and no box overlaps two others above 0.75 (where the
    list NMS's skip after a removal would keep a box that standard greedy
    NMS drops; ``boxes.nms``)."""
    rng = np.random.default_rng(seed)
    per = []
    for h, w in GRIDS:
        n = h * w * A
        rows = np.empty((n, 6), np.float32)
        rows[:, 0] = rng.integers(0, 2, n)
        rows[:, 1] = rng.uniform(0.0, 0.5, n)
        rows[:, 2:4] = rng.uniform(0.05, 0.95, (n, 2))
        rows[:, 4:6] = rng.uniform(0.01, 0.04, (n, 2))
        per.append(rows)
    slots = [iter(rng.permutation(len(r))) for r in per]

    def put(s, row):
        per[s][next(slots[s])] = row

    for _ in range(6):  # objects at every scale
        cls = int(rng.integers(0, 2))
        c = rng.uniform(0.2, 0.8, 2)
        wh = rng.uniform(0.1, 0.25, 2)
        for s in range(3):
            k = cls if rng.random() < 0.8 else 1 - cls
            put(s, [k, rng.uniform(0.4, 1.0), *(c + rng.normal(0, 0.03, 2)),
                    *(wh * rng.uniform(0.7, 1.3, 2))])
    x, y = rng.uniform(0.2, 0.8, 2)
    put(2, [0, 0.93, x, y, 0.06, 0.05])  # a same-scale pair
    put(2, [0, 0.91, x + 0.002, y, 0.06, 0.05])
    x, y = rng.uniform(0.2, 0.8, 2)
    put(0, [1, 0.97, x, y, 8e-4, 0.1])  # fails the size bound, removes:
    put(1, [1, 0.92, x, y, 1.2e-3, 0.1])
    x, y = rng.uniform(0.2, 0.8, 2)
    put(1, [0, 0.55, x, y, 0.05, 0.05])  # under scale 1's floor, removes:
    put(2, [0, 0.50, x, y, 0.05, 0.05])
    return per


def check_construction(per, flat):
    """candidates()' promises: entering scores distinct, no entering IoU
    within 1e-6 of a threshold, and no box of NMS's input (flat above the
    threshold, of a size NMS takes) above NMS's IoU with two others."""
    rows = np.concatenate(per).astype(np.float64)
    ent = rows[rows[:, 1] > THR]
    assert len(np.unique(ent[:, 1])) == len(ent)
    ov = iou(ent[:, None, 2:6], ent[None, :, 2:6])[..., 0]
    for t in (XIOU, NMS_IOU):
        assert not (np.abs(ov - t) < 1e-6).any()
    b = np.asarray(flat, np.float64).reshape(-1, 6)
    wh = b[:, 4:6]
    b = b[(b[:, 1] > THR) & ((wh > 10e-4) & (wh < 10e4)).all(1)]
    ov = iou(b[:, None, 2:6], b[None, :, 2:6])[..., 0]
    np.fill_diagonal(ov, 0.0)
    assert ((ov > NMS_IOU).sum(1) <= 1).all()


def host_chain(per, floors, cross_iou):
    """vis_step's chain on the host: the per-scale lists, _filter_scales
    (floors, then suppress_cross_scale), the list NMS."""
    trainer = types.SimpleNamespace(num_scales=len(per),
                                    cross_scale_nms_iou=cross_iou)
    lists = [r.tolist() for r in per]
    flat = YOLOTrainer._filter_scales(trainer, lists, floors)
    kept, _, _ = nms(flat, NMS_IOU, THR, allow_empty=True)
    return flat, kept


def device_chain(per, floors, cross_iou):
    boxes = torch.from_numpy(np.concatenate(per))
    scale = torch.cat([torch.full((len(r),), s) for s, r in enumerate(per)])
    with profiling.recording():
        xs = cross_scale_padded(boxes, scale, cross_iou, THR, floors)
        # room for every box (the host list NMS keeps any number)
        kept, valid = nms_padded(xs, NMS_IOU, THR, 256)
        counts = profiling.counters()
    return xs, kept[valid], counts


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("floors,cross_iou", [(None, XIOU),
                                              ([0.5, 0.6, 0.0], XIOU),
                                              (None, 0.0)])
def test_device_chain_equals_host_chain(seed, floors, cross_iou):
    per = candidates(seed)
    flat, host_kept = host_chain(per, floors, cross_iou)
    check_construction(per, flat)
    xs, kept, counts = device_chain(per, floors, cross_iou)
    # the cross-scale pass: the rows it keeps above the threshold, by
    # descending score (the host returns them so where the pass is on)
    host_x = sorted((b for b in flat if b[1] > THR), key=lambda b: -b[1])
    survivors = xs[torch.isfinite(xs[:, 1])]
    assert torch.equal(survivors, torch.tensor(
        host_x, dtype=torch.float32).reshape(-1, 6))
    # then NMS: the kept rows, in order
    assert torch.equal(kept, torch.tensor(host_kept,
                                          dtype=torch.float32).reshape(-1, 6))
    assert counts["xscale_in"] == xs.shape[0]
    assert counts["xscale_dropped"] == xs.shape[0] - survivors.shape[0]
    # the planted cases: the box that passes the size bound (score 0.92)
    # is removed by the one that fails it; the box under scale 1's floor
    # removes the one of score 0.50 only where there are no floors
    scores = survivors[:, 1].tolist()
    assert (np.float32(0.92) in scores) == (cross_iou == 0)
    assert (np.float32(0.50) in scores) == (floors is not None
                                            or cross_iou == 0)
    assert (counts["xscale_dropped"] > 0) == (cross_iou > 0)


def test_decode_scales_matches_host_decode():
    rng = np.random.default_rng(5)
    anchors = rng.uniform(0.02, 0.9, (3, A, 2)).astype(np.float32)
    n = sum(h * w for h, w in GRIDS)
    pred = rng.normal(size=(1, n, A, 7)).astype(np.float32)
    boxes, scale = decode_scales(torch.from_numpy(pred), GRIDS,
                                 torch.from_numpy(anchors))
    host, at = [], 0
    for s, (h, w) in enumerate(GRIDS):
        cells = pred[:, at:at + h * w].reshape(1, h, w, A, 7)
        host += convert_cells_to_bboxes(cells, anchors[s], h, w)[0]
        at += h * w
    host = np.asarray(host, np.float32)
    got = boxes[0].numpy()
    np.testing.assert_array_equal(got[:, 0], host[:, 0])
    np.testing.assert_allclose(got, host, rtol=1e-6, atol=1e-7)
    want = np.concatenate([np.full(h * w * A, s) for s, (h, w)
                           in enumerate(GRIDS)])
    np.testing.assert_array_equal(scale.numpy(), want)


def test_scales_rays_are_the_grids_rays():
    rng = np.random.default_rng(6)
    pose = torch.linalg.inv(torch.as_tensor(
        _look_at(rng.normal(size=3) * 2.5), dtype=torch.float32))[None]
    focal, c = np.float32([150.0, 150.0]), np.float32([64.0, 64.0])
    rays, grids = gen_rays_yolo_scales(pose, 128, 128, focal, c,
                                       [32, 16, 8], 1.2, 4.0)
    assert grids == [(4, 4), (8, 8), (16, 16)]
    offsets = _offsets(grids)
    for s, cs in enumerate([32, 16, 8]):
        one = gen_rays_yolo(pose, 128 // cs, 128 // cs, focal / cs, c / cs,
                            1.2, 4.0).reshape(1, -1, 8)
        assert torch.equal(rays[:, offsets[s]:offsets[s + 1]], one)


def _offsets(grids):
    """Where each grid's rays start in the batch, and the batch's end."""
    return [0, *np.cumsum([h * w for h, w in grids]).tolist()]


def _look_at(origin):
    back = origin / np.linalg.norm(origin)
    right = np.cross([0.0, 1.0, 0.0], back)
    right /= np.linalg.norm(right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = right, np.cross(back, right), back
    c2w[:3, 3] = origin
    return c2w


# -- a small model: one render of every grid, and the plain reference ------


@pytest.fixture(scope="module")
def small():
    """The benchmark's three-scale configuration at a 32-wide field, 64 x
    64 views and 8 samples, float32: the port's model and the reference
    with one set of seeded weights, a scene and its draws."""
    from benchmark import common, harness

    torch.manual_seed(0)
    cfg = copy.deepcopy(harness.load_cell("yolo3s_detect").config)
    cfg["scene"].update({"image_size": 64, "focal": 75.0})
    cfg["conf"]["renderer"]["n_coarse"] = 8
    cfg["conf"]["model"]["compute_dtype"] = "float32"
    cfg["conf"]["model"]["mlp_coarse"]["d_hidden"] = 32
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    weights = common.benchmark_weights(cfg, 11, "cpu")
    model = common.program_model(cfg, weights, "cpu")
    ref = common.reference_model(cfg, "cpu").eval()
    from benchmark import weights as W

    W.load_into(ref, weights)
    rng = np.random.default_rng(12)
    w2c = torch.as_tensor(common.ring_extrinsics(4, 2.6, 0.6, rng))
    images = common.object_images(torch.Generator().manual_seed(13), 3, 64,
                                  "cpu")[None]
    yield types.SimpleNamespace(cfg=cfg, model=model, ref=ref, w2c=w2c,
                                images=images)
    torch.set_num_threads(n)


def _program_render(small, rays, u):
    from pixelnerf_yolo_torch.config.hocon import Config
    from pixelnerf_yolo_torch.render import make_renderer

    renderer = make_renderer(Config(small.cfg["conf"]), device="cpu")
    focal, c = torch.full((1, 2), 75.0), torch.full((1, 2), 32.0)
    with torch.no_grad():
        cond = small.model.encode(small.images, small.w2c[None, :3], focal,
                                  c=c)
        return renderer(small.model, cond, rays, u=u)


def test_one_render_of_every_grid(small):
    """The rays of the three grids in one YoloRenderer call give what a
    call on each grid's rays gives (the draws sliced with them)."""
    focal, c = np.float32([75.0, 75.0]), np.float32([32.0, 32.0])
    rays, grids = gen_rays_yolo_scales(small.w2c[3:], 64, 64, focal, c,
                                       [32, 16, 8], 1.2, 4.0)
    offsets = _offsets(grids)
    u = torch.rand((rays.shape[1], 8), generator=torch.Generator()
                   .manual_seed(14))
    whole = _program_render(small, rays[0], u)
    parts = torch.cat([
        _program_render(small, rays[0, a:b], u[a:b])
        for a, b in zip(offsets[:-1], offsets[1:])])
    torch.testing.assert_close(whole, parts, rtol=1e-5, atol=1e-6)


def test_port_against_reference(small):
    """Candidates of the port's one-batch render against the reference's
    (float32 rounding apart), and the reference's cross-scale pass and NMS
    of the port's candidates equal to the port's, at a threshold that
    about a fifth of them pass."""
    from benchmark.reference import multiscale as ms

    y = small.cfg["conf"]["yolo"]
    focal, c = np.float32([75.0, 75.0]), np.float32([32.0, 32.0])
    rays, grids = gen_rays_yolo_scales(small.w2c[3:], 64, 64, focal, c,
                                       y["cell_sizes"], 1.2, 4.0)
    u = torch.rand((rays.shape[1], 8), generator=torch.Generator()
                   .manual_seed(15))
    out = _program_render(small, rays[0], u)
    anchors = torch.tensor(y["anchors"])
    cand, scale = decode_scales(out[None], grids, anchors)
    cand = cand[0]
    ref_rays, ref_grids = ms.grid_rays(small.w2c[3], 64, 75.0,
                                       y["cell_sizes"], 1.2, 4.0)
    assert ref_grids == grids
    torch.testing.assert_close(ref_rays, rays[0], rtol=1e-5, atol=1e-6)
    with torch.no_grad():
        cond = small.ref.encode(small.images, small.w2c[None, :3],
                                torch.full((1, 2), 75.0),
                                torch.full((1, 2), 32.0))
        ref_out = ms.render_grids(small.ref, cond, ref_rays, u, A, 32)
    rc, ref_scale = ms.decode_grids(ref_out, grids, y["anchors"])
    assert torch.equal(scale, ref_scale)
    torch.testing.assert_close(cand[:, 1:], rc[:, 1:], rtol=1e-4, atol=1e-5)
    thr = float(cand[:, 1].quantile(0.8))
    xs = cross_scale_padded(cand, scale, XIOU, thr)
    kept, valid = nms_padded(xs, NMS_IOU, thr, 64)
    want = ms.detect_index(cand, scale, XIOU, NMS_IOU, thr)
    assert torch.equal(kept[valid], cand[want])
    survivors = xs[torch.isfinite(xs[:, 1])]
    assert torch.equal(survivors, cand[ms.cross_scale(cand, scale, XIOU,
                                                      thr)])
