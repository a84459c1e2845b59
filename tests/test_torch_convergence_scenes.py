"""scripts/torch_convergence.py on the CPU: its in-memory scenes against
what the port's disk readers read from tests/synth_data.py's files, and a
toy-size run of each subcommand (a few steps, random weights) that checks
its JSON line."""

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest

from synth_data import make_srn_dataset, make_yolo_dataset

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these runs are many small ops, which gain
    nothing from a thread pool and lose much to one when test workers
    share the cores."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tc():
    spec = importlib.util.spec_from_file_location(
        "torch_convergence", REPO / "scripts" / "torch_convergence.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _assert_items_equal(got, want, image_tol=0.0):
    """Every key of a reader's item (but its file path) equal; images
    within image_tol."""
    assert got.keys() == want.keys()
    for key in want:
        if key == "path":
            continue
        g, w = got[key], want[key]
        if key == "images":
            assert g.shape == w.shape and g.dtype == w.dtype
            assert np.abs(g - w).max() <= image_tol
        elif key == "bboxes":  # per view, a tuple of per-scale grids
            assert len(g) == len(w)
            for gv, wv in zip(g, w):
                assert len(gv) == len(wv)
                for gs, ws in zip(gv, wv):
                    np.testing.assert_array_equal(gs, ws)
        else:
            assert np.asarray(g).dtype == np.asarray(w).dtype, key
            np.testing.assert_array_equal(g, w, err_msg=key)


@pytest.mark.parametrize("recipe", ["yolo", "yolo3s"])
def test_yolo_scenes_match_reader(tmp_path, tc, recipe):
    """yolo_scenes against YOLODataset reading make_yolo_dataset's files
    with the same arguments: poses, focal, c and grid targets exact, images
    within one uint8 level (2/255: cv2's fixed-point bilinear)."""
    from pixelnerf_yolo_torch.config.hocon import parse_file
    from pixelnerf_yolo_torch.data import get_split_dataset

    conf = parse_file(str(REPO / tc.YOLO_CONFS[recipe]))
    data = ({"n_scenes": 4, "seed": 11, "randomize": True}
            if recipe == "yolo3s" else {"n_scenes": 2, "seed": 4})
    root = make_yolo_dataset(str(tmp_path / "data"), n_views=10,
                             img_size=256, **data)
    disk = get_split_dataset("yolo", root, conf=conf)
    memory = tc.yolo_scenes(conf, n_views=10, img_size=256, **data)
    for got, want in zip(memory, disk):
        assert (got.z_near, got.z_far) == (want.z_near, want.z_far)
        assert len(got) == len(want)
    levels = []
    for split, (got, want) in enumerate(zip(memory, disk)):
        if split == 0:  # ColorJitterDataset: compare the scenes under it
            got, want = got.base_dset, want.base_dset
        for i in range(len(want)):
            g, w = got[i], want[i]
            _assert_items_equal(g, w, image_tol=2 / 255 + 1e-6)
            levels.append(np.abs(g["images"] - w["images"]).max() * 127.5)
    # the grids carry both boxes of every view (a non-empty target)
    assert all((g[0][..., 0] == 1).sum() >= 1 for g in memory[1][0]["bboxes"])
    print("largest image difference, uint8 levels:", max(levels))


def test_resize_linear_within_one_level_of_cv2(tc):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    for shape, fx, fy in [((256, 256, 3), 0.5, 0.47407),
                          ((64, 80, 3), 0.3, 0.71), ((33, 17, 3), 1.7, 2.0)]:
        img = rng.integers(0, 256, size=shape, dtype=np.uint8)
        want = cv2.resize(img, (0, 0), fx=fx, fy=fy)
        got = tc.resize_linear(img, fx, fy)
        assert got.shape == want.shape
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("kw", [
    {"n_objs": 6, "n_views": 8, "img_size": 32},
    {"n_objs": 2, "n_views": 8, "img_size": 32, "seed": 77},
    {"n_objs": 1, "n_views": 8, "img_size": 64},
])
def test_srn_scenes_match_reader(tmp_path, tc, kw):
    """srn_scenes against the port's SRN reader (resizing to 128x128) on
    make_srn_dataset's files: every array exact."""
    from pixelnerf_yolo_torch.data import SRNDataset

    root = str(tmp_path / "cars")
    make_srn_dataset(root, stage="train", **kw)
    want = SRNDataset(root, stage="train")
    got = tc.srn_scenes(**kw)
    assert (got.z_near, got.z_far) == (want.z_near, want.z_far)
    assert len(got) == len(want) == kw["n_objs"]
    for i in range(len(want)):
        _assert_items_equal(got[i], want[i])


def test_nerf_conf_is_the_tests(tc):
    """The script's NeRF recipe conf is tests/test_train_integration.py's
    NERF_TRAIN_CONF at d_hidden 128, as the JAX recipes use it."""
    from test_train_integration import NERF_TRAIN_CONF

    from pixelnerf_yolo_torch.config.hocon import parse_string

    want = parse_string(NERF_TRAIN_CONF.replace("d_hidden = 64",
                                                "d_hidden = 128"))
    assert tc.nerf_conf().to_dict() == want.to_dict()


TOY_YOLO = ["--set", "model.mlp_coarse.d_hidden=64",
            "--set", "renderer.n_coarse=8",
            "--set", "model.encoder.backbone=resnet18",
            "--set", "model.encoder.num_layers=2",
            "--set", "model.encoder.pretrained=false",
            "--set", "train.num_epoch_repeats=1"]
TOYS = {
    "early_term": ["--steps", "2", "--rays", "64", "--fracs", "0.5,0.25",
                   "--image_size", "32"],
    "nerf_multiscene": ["--steps", "2", "--rays", "32", "--image_size", "32"],
    "yolo": ["--epochs", "2"] + TOY_YOLO,
    "yolo3s": ["--epochs", "1", "--grid", "0.9",
               "--set", "yolo.cell_sizes=[32,32,32]"] + TOY_YOLO,
}


@pytest.mark.parametrize("recipe", list(TOYS))
def test_subcommand_json_line(tmp_path, tc, recipe):
    """A toy run of each subcommand on the CPU: exit 0 and a last line of
    JSON with the recipe's result, wall time, card and launch counts (none
    off the card)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tc.main([recipe, "--device", "cpu", "--workdir", str(tmp_path),
                      "--out", str(tmp_path / "line.json")] + TOYS[recipe])
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line == json.loads((tmp_path / "line.json").read_text())
    assert line["recipe"] == recipe and line["ok"] is True
    assert line["device"] == "cpu" and isinstance(line["nvidia_smi"], str)
    assert line["wall_s"] > 0 and line["train_s"] > 0
    assert line["build_s"] is None  # no kernel build off the card
    assert line["route"] == {"expected": [], "refused": []}
    assert line["train_launches"] == {} and line["eval_launches"] == {}
    if recipe in ("early_term", "nerf_multiscene"):
        assert np.isfinite(line["loss"])
    if recipe == "early_term":
        assert [s["f"] for s in line["sweep"]] == [0.5, 0.25]
        for s in line["sweep"]:
            assert set(s) == {"f", "psnr_gt", "delta_db", "psnr_vs_ungated",
                              "fine_rays_per_chunk", "chunk_rays",
                              "gated_share"}
            assert 0 < s["gated_share"] < 1
        assert np.isfinite(line["psnr_ungated"])
    elif recipe == "nerf_multiscene":
        assert np.isfinite(line["psnr0"]) and np.isfinite(line["psnr"])
        assert line["steps"] == 2 and set(line["first_losses"]) >= {"t"}
    else:
        epochs = 2 if recipe == "yolo" else 1
        assert line["epochs"] == epochs
        assert line["steps"] == epochs * line["steps_per_epoch"]
        assert line["stop"] == "done"
        assert set(line["first_losses"]) == {
            "t", "box_loss", "object_loss", "no_object_loss", "class_loss"}
        for m in line["in_train_metrics"]:
            assert set(m) == {"epoch", "step", "precision", "recall", "f1"}
        keys = {"precision", "recall", "f1", "map50", "per_class", "tp", "fp",
                "fn"}
        assert set(line["latest"]) == keys
        assert line["best"] is None or set(line["best"]) == keys
        if recipe == "yolo3s":
            assert [r["taus"] for r in line["calibration"]["top"]] == [
                [0.9, 0.9, 0.9]]
            assert set(line["latest_calibrated"]) == keys


def test_visualizations_without_cv2_or_imageio(tmp_path, monkeypatch):
    """What the trainers' vis steps use where cv2 and imageio are missing
    (the card): write_png reads back exactly, the numpy HOT map and the
    numpy box outlines."""
    import sys

    import imageio.v2 as imageio

    from pixelnerf_yolo_torch.detect.boxes import draw_bounding_boxes
    from pixelnerf_yolo_torch.utils import image

    rng = np.random.default_rng(0)
    for shape in [(7, 5, 3), (4, 9)]:
        img = rng.integers(0, 256, size=shape, dtype=np.uint8)
        image.write_png(str(tmp_path / "x.png"), img)
        np.testing.assert_array_equal(imageio.imread(tmp_path / "x.png"), img)

    monkeypatch.setattr(image, "cv2", None)
    hot = image.cmap(np.linspace(0, 1, 12).reshape(3, 4))
    assert hot.shape == (3, 4, 3) and hot.dtype == np.uint8
    assert hot[0, 0].tolist() == [0, 0, 0] and hot[-1, -1].tolist() == [
        255, 255, 255]
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 raises
    canvas = np.zeros((20, 20, 3), np.float32)
    drawn = draw_bounding_boxes(canvas, [[1, 0.9, 0.5, 0.5, 0.5, 0.5]])
    assert drawn.shape == canvas.shape and drawn.dtype == np.float32
    outline = np.flatnonzero(drawn.any(axis=-1).any(axis=0))
    assert outline.tolist() == list(range(5, 16))
    assert not drawn[6:15, 6:15].any()  # outlines only
