"""A run with the timed path broken underneath comes out not correct:
the harness's run without its look for a card, at test size, with one
fault planted in the program (the checks as the limits files set them)."""

import importlib
import time

import pytest
import torch

from conftest import tiny_cell


def run(name):
    from benchmark import harness

    res = harness.execute(tiny_cell(name), 2 ** 33 + 29, 0.3, False, "cpu",
                          time.perf_counter())
    return res


def test_sound_runs_pass():
    for name in ("srn_views", "yolo_train", "yolo_detect"):
        assert run(name)["correct"], name


def test_views_image_altered(monkeypatch):
    import pixelnerf_yolo_torch.render.nerf as nerf

    composite = nerf.composite

    def altered(*args, **kwargs):
        w, rgb, depth = composite(*args, **kwargs)
        return w, rgb + 0.02, depth

    monkeypatch.setattr(nerf, "composite", altered)
    assert not run("srn_views")["correct"]


def test_detect_box_altered(monkeypatch):
    # the module (the package's name ``nms`` is the host NMS function)
    nms = importlib.import_module("pixelnerf_yolo_torch.detect.nms")

    nms_padded = nms.nms_padded

    def altered(boxes, *args, **kwargs):
        kept, valid = nms_padded(boxes, *args, **kwargs)
        return kept + torch.tensor([0, 0, 1e-3, 0, 0, 0]), valid

    monkeypatch.setattr(nms, "nms_padded", altered)
    res = run("yolo_detect")
    assert not res["correct"] and res["checks"]["nms_mismatch"]["value"] > 0


def test_detect_boxes_dropped(monkeypatch):
    """NMS keeps nothing: the reference's own NMS keeps boxes that no
    kept box matches."""
    nms = importlib.import_module("pixelnerf_yolo_torch.detect.nms")
    nms_padded = nms.nms_padded

    def dropped(boxes, *args, **kwargs):
        kept, valid = nms_padded(boxes, *args, **kwargs)
        return kept, torch.zeros_like(valid)

    monkeypatch.setattr(nms, "nms_padded", dropped)
    res = run("yolo_detect")
    assert not res["correct"] and res["checks"]["nms_unmatched"]["value"] > 0


def test_detect_candidates_altered(monkeypatch):
    import pixelnerf_yolo_torch.render.yolo as yolo

    agg = yolo.yolo_aggregate
    monkeypatch.setattr(yolo, "yolo_aggregate",
                        lambda *a, **k: agg(*a, **k) * 1.1)
    assert not run("yolo_detect")["correct"]


def test_train_step_leaves_state_unchanged(monkeypatch):
    from pixelnerf_yolo_torch.train.trainer import Trainer

    def no_update(self, total):
        self.optimizer.zero_grad(set_to_none=True)
        total.backward()

    monkeypatch.setattr(Trainer, "backward_and_step", no_update)
    res = run("yolo_train")
    assert not res["correct"]
    assert res["checks"]["delta_gap_median"]["value"] == pytest.approx(1.0)
    assert res["checks"]["delta_gap"]["value"] == pytest.approx(1.0)


def test_train_half_the_batch(monkeypatch):
    """Half of each chunk's rays left out, the mean taken over the rest."""
    from pixelnerf_yolo_torch.losses.yolo import YoloLoss

    call = YoloLoss.__call__

    def half(self, pred, target, anchors, counts=None):
        n = pred.shape[0] // 2
        return call(self, pred[:n], target[:n], anchors, counts)

    monkeypatch.setattr(YoloLoss, "__call__", half)
    assert not run("yolo_train")["correct"]


def test_train_answer_altered(monkeypatch):
    """The aggregated box and class values x 1.5 where they are made (at
    the cell's own size on the card x 1.1 reads 0.057-0.062 in
    loss_gap)."""
    import pixelnerf_yolo_torch.render.yolo as yolo

    agg = yolo.yolo_aggregate

    def altered(*args, **kwargs):
        out = agg(*args, **kwargs)
        return torch.cat([out[..., :1], out[..., 1:] * 1.5], -1)

    monkeypatch.setattr(yolo, "yolo_aggregate", altered)
    assert not run("yolo_train")["correct"]
