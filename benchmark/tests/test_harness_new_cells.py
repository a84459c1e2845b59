"""The ``yolo3s_detect`` and ``srn_train`` cells: found by name, their
references free of the program and of JAX, sound runs correct at test
size on the CPU (float32), and faults planted in the program caught: the
cross-scale pass skipped, the training step leaving the state unchanged,
and a program without the multi-scale functions refused at once."""

import copy
import importlib
import time

import pytest
import torch

from test_harness_imports import FORBIDDEN, PROGRAM, loaded_after

SEED = 2 ** 33 + 41

# per cell: (scene, conf and traffic changes) at test size.  The detection
# cell keeps its anchors; at 128 x 128 its coarsest grid has 4 x 4 cells,
# so the placed object is larger (0.4 of the view) and more candidates
# pass, that a request has boxes the cross-scale pass removes
TINY = {
    "yolo3s_detect": ({"image_size": 128, "focal": 150.0},
                      {"renderer": {"n_coarse": 16}},
                      {"check_requests": 2, "warmup_requests": 1,
                       "objects_per_request": 48, "object_size": 0.4,
                       "check_block_rays": 128,
                       "trace": {"skip": 0, "units": 1}}),
    "srn_train": ({"image_size": 32, "focal": 32.8125},
                  {"renderer": {"n_coarse": 16, "n_fine": 8,
                                "n_fine_depth": 4}},
                  {"objects": 3, "views": 4, "sb": 2, "rays_per_object": 16,
                   "trace": {"skip": 0, "units": 1}}),
}
E2E = {"yolo3s_detect": "view_p95_ms", "srn_train": "train_steps_per_s"}


def tiny_cell(name):
    from benchmark import harness

    cell = harness.load_cell(name)
    scene, conf, traffic = TINY[name]
    cfg = copy.deepcopy(cell.config)
    cfg["scene"].update(scene)
    for section, puts in conf.items():
        cfg["conf"][section].update(puts)
    cfg["conf"]["model"]["compute_dtype"] = "float32"
    for mlp in ("mlp_coarse", "mlp_fine"):
        if cfg["conf"]["model"][mlp].get("type") == "resnet":
            cfg["conf"]["model"][mlp]["d_hidden"] = 64
    cell.config = cfg
    cell.traffic = dict(cell.traffic, **traffic)
    return cell


def run(name, trace=False, seconds=0.3, **traffic):
    from benchmark import harness

    cell = tiny_cell(name)
    cell.traffic.update(traffic)
    readings = {}
    res = harness.execute(cell, SEED, seconds, trace, "cpu",
                          time.perf_counter(), readings=readings)
    return res, readings


def test_cells_found_by_name():
    from benchmark import harness

    det, tr = (harness.load_cell(n) for n in ("yolo3s_detect", "srn_train"))
    assert det.traffic["driver"] == "detect3s"
    assert tr.traffic["driver"] == "train_nerf"
    assert det.config["name"] == "nerf_yolo_3scale"
    assert det.config["conf"]["yolo"]["cell_sizes"] == [32, 16, 8]
    assert tr.config["name"] == "pixelnerf_srn_cars"
    assert {m["name"] for m in det.end_to_end} == {"view_p95_ms", "setup_s"}
    assert {m["name"] for m in tr.end_to_end} == {"train_steps_per_s",
                                                 "setup_s"}
    assert {"xscale_ms.detect", "xscale_dropped.detect", "mfu.detect",
            "nms_ms.detect"} <= {m["name"] for m in det.per_layer}
    assert {"mfu.train", "assemble_ms.train", "backward_ms.train"} <= {
        m["name"] for m in tr.per_layer}
    assert set(det.limits["limits"]) == {"cand_exc", "class_flips",
                                         "xscale_mismatch", "nms_mismatch",
                                         "nms_unmatched"}
    assert set(tr.limits["limits"]) == {"loss_gap", "grad_exc",
                                        "delta_gap_median", "delta_gap"}


def test_new_references_load_nothing_of_the_program():
    mods = loaded_after("import benchmark.reference.multiscale, "
                        "benchmark.reference.train_nerf")
    assert not mods & (FORBIDDEN | {PROGRAM})


@pytest.mark.parametrize("name", sorted(TINY))
def test_sound_run_passes(name):
    res, nums = run(name)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {E2E[name], "setup_s"}
    if name == "yolo3s_detect":
        assert nums["xscale_dropped"] > 0 and nums["kept_boxes"] > 0


@pytest.mark.parametrize("name", sorted(TINY))
def test_traced_run(name):
    res, _ = run(name, trace=True)
    assert res["correct"]
    mfu = [k for k in res["metrics"] if k.startswith("mfu.")]
    assert len(mfu) == 1 and 0 < res["metrics"][mfu[0]]["value"] <= 100
    if name == "yolo3s_detect":
        assert res["metrics"]["xscale_ms.detect"]["value"] > 0
        assert res["metrics"]["xscale_dropped.detect"]["value"] >= 0
    else:
        assert res["metrics"]["assemble_ms.train"]["value"] > 0


def test_cross_scale_skipped(monkeypatch):
    """The pass filters by score but removes nothing: the kept boxes are
    not the reference's."""
    nms = importlib.import_module("pixelnerf_yolo_torch.detect.nms")
    cross = nms.cross_scale_padded

    def skipped(boxes, scale, cross_iou, *args, **kwargs):
        return cross(boxes, scale, 0.0, *args, **kwargs)

    monkeypatch.setattr(nms, "cross_scale_padded", skipped)
    res, _ = run("yolo3s_detect")
    assert not res["correct"]
    assert res["checks"]["xscale_mismatch"]["value"] > 0


def test_sound_run_at_the_box_cap():
    """NMS keeps max_boxes on both sides: which boxes near the last one's
    score make the cut is rounding's choice, and the check allows it."""
    res, nums = run("yolo3s_detect", max_boxes=3)
    assert res["correct"], res["checks"]
    assert nums["kept_max"] == 3


def test_detect3s_boxes_dropped(monkeypatch):
    """NMS keeps nothing: the reference's chain keeps boxes that no kept
    box matches."""
    nms = importlib.import_module("pixelnerf_yolo_torch.detect.nms")
    nms_padded = nms.nms_padded

    def dropped(boxes, *args, **kwargs):
        kept, valid = nms_padded(boxes, *args, **kwargs)
        return kept, torch.zeros_like(valid)

    monkeypatch.setattr(nms, "nms_padded", dropped)
    res, _ = run("yolo3s_detect")
    assert not res["correct"] and res["checks"]["nms_unmatched"]["value"] > 0


def test_program_without_multiscale_refused(monkeypatch):
    """A program without the multi-scale functions (the parent commit)
    fails in set-up, before any request."""
    nms = importlib.import_module("pixelnerf_yolo_torch.detect.nms")
    monkeypatch.delattr(nms, "cross_scale_padded")
    from benchmark.drivers.detect3s import Driver

    cell = tiny_cell("yolo3s_detect")
    drv = Driver(cell.config, cell.traffic, SEED, "cpu")
    t0 = time.perf_counter()
    with pytest.raises(ImportError):
        drv.setup()
    assert time.perf_counter() - t0 < 5.0


def test_train_nerf_leaves_state_unchanged(monkeypatch):
    from pixelnerf_yolo_torch.train.trainer import Trainer

    def no_update(self, total):
        self.optimizer.zero_grad(set_to_none=True)
        total.backward()

    monkeypatch.setattr(Trainer, "backward_and_step", no_update)
    res, _ = run("srn_train")
    assert not res["correct"]
    assert res["checks"]["delta_gap_median"]["value"] == pytest.approx(1.0)
    assert res["checks"]["delta_gap"]["value"] == pytest.approx(1.0)


def test_train_nerf_half_the_rays(monkeypatch):
    """The loss over half of the rays: the step is not the reference's."""
    import pixelnerf_yolo_torch.train.nerf_trainer as nt

    loss = nt.weighted_rgb_loss

    def half(crit, outputs, targets, w, w_total=None):
        n = outputs.shape[-2] // 2
        return loss(crit, outputs[..., :n, :], targets[..., :n, :],
                    w[..., :n], w_total)

    monkeypatch.setattr(nt, "weighted_rgb_loss", half)
    res, _ = run("srn_train")
    assert not res["correct"]

