"""The port's numpy copies of the training data path against the JAX
package's on the CPU, exactly: YOLODataset items and their grid targets,
the color jitter, the DataLoader's batches, the YOLO trainer's batch
assembly, the image helpers, argument parsing and the training conf of
``config/flagship.py``."""

import os

import numpy as np
import pytest

from synth_data import make_yolo_dataset

from pixelnerf_yolo_tpu.config import hocon as jhocon
from pixelnerf_yolo_tpu.data import color_jitter as jcj
from pixelnerf_yolo_tpu.data import loader as jloader
from pixelnerf_yolo_tpu.data import yolo as jyolo
from pixelnerf_yolo_tpu.data import base as jbase
from pixelnerf_yolo_tpu.utils import image as jimage
from pixelnerf_yolo_torch.config import hocon
from pixelnerf_yolo_torch.data import base, color_jitter, loader, yolo
from pixelnerf_yolo_torch.utils import image

MULTI_SCALE = """
model { mlp_coarse { num_scales = 3
                    num_anchors_per_scale = 3 } }
yolo {
    image_scale = [0.5, 0.5]
    cell_sizes = [32, 16, 8]
    anchors = [
        [[0.02, 0.03], [0.04, 0.07], [0.08, 0.06]],
        [[0.07, 0.15], [0.15, 0.11], [0.14, 0.29]],
        [[0.28, 0.22], [0.38, 0.48], [0.9, 0.78]]
    ]
    ignore_iou_thresh = 0.5
}
"""


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_yolo_dataset(str(tmp_path_factory.mktemp("data") / "d"),
                             n_scenes=3, n_views=4, img_size=64,
                             randomize=True)


def _assert_same(a, b, where="item"):
    """Equal structure and exactly equal arrays and values."""
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def _confs(text):
    return jhocon.parse_string(text), hocon.parse_string(text)


@pytest.mark.parametrize("stage", ["train", "val", "test"])
@pytest.mark.parametrize("scales", [1, 3])
def test_yolo_dataset_items_match_jax(root, stage, scales):
    """Images, poses, focal, c and the per-view, per-scale grid targets."""
    from torch_parity import yolo_train_conf

    if scales == 1:
        jc = yolo_train_conf(jhocon.parse_string, "true")
        tc = yolo_train_conf(hocon.parse_string, "true")
    else:
        jc, tc = _confs(MULTI_SCALE)
    jd = jyolo.YOLODataset(root, stage=stage, conf=jc)
    td = yolo.YOLODataset(root, stage=stage, conf=tc)
    assert len(jd) == len(td) > 0
    for i in range(len(jd)):
        item = td[i]
        _assert_same(item, jd[i])
        assert len(item["bboxes"]) == 4 and len(item["bboxes"][0]) == scales
        assert (item["bboxes"][0][0][..., 0] == 1).any()


def test_grid_targets_match_jax(rng):
    """``_get_all_bboxes`` on random boxes at three scales: best-anchor
    assignment, cell coordinates, classes and the ignore flag (-1)."""
    jc, tc = _confs(MULTI_SCALE)
    jd = jyolo.YOLODataset.__new__(jyolo.YOLODataset)
    jd.num_scales = 3
    jd.num_anchors_per_scale = 3
    jd.cell_sizes = [32, 16, 8]
    jd.anchors = np.array([a for s in jc["yolo.anchors"] for a in s],
                          np.float32)
    jd.ignore_iou_thresh = 0.5
    td = yolo.YOLODataset.__new__(yolo.YOLODataset)
    td.set_target_conf(tc)
    for k in ("num_scales", "num_anchors_per_scale", "cell_sizes",
              "ignore_iou_thresh"):
        assert getattr(td, k) == getattr(jd, k), k
    np.testing.assert_array_equal(td.anchors, jd.anchors)
    for n in (1, 5, 40):
        boxes = np.concatenate([rng.uniform(0.01, 0.99, (n, 2)),
                                rng.uniform(0.01, 0.6, (n, 2)),
                                rng.integers(0, 2, (n, 1))], axis=1).tolist()
        got = td._get_all_bboxes(boxes, 128, 96)
        _assert_same(got, jd._get_all_bboxes(boxes, 128, 96), f"{n} boxes")
    assert any((t[..., 0] == -1).any() for t in got)


def test_color_jitter_matches_jax(root):
    jc, tc = _confs(MULTI_SCALE)
    jbase_set = jyolo.YOLODataset(root, stage="train", conf=jc)
    tbase_set = yolo.YOLODataset(root, stage="train", conf=tc)
    jj = jcj.ColorJitterDataset(jbase_set, rng=np.random.default_rng(7))
    tj = color_jitter.ColorJitterDataset(tbase_set,
                                         rng=np.random.default_rng(7))
    for attr in ("z_near", "z_far", "base_path"):
        assert getattr(tj, attr) == getattr(jj, attr)
    for i in (0, 1, 0):
        _assert_same(tj[i], jj[i])
    img = np.random.default_rng(3).uniform(0, 1, (3, 8, 8)).astype(np.float32)
    for name in ("adjust_brightness", "adjust_contrast", "adjust_saturation",
                 "adjust_hue"):
        for f in (0.8, 1.1) if name != "adjust_hue" else (-0.1, 0.07):
            np.testing.assert_array_equal(getattr(color_jitter, name)(img, f),
                                          getattr(jcj, name)(img, f))


@pytest.mark.parametrize("workers", [0, 2])
def test_data_loader_batches_match_jax(root, workers):
    """Shuffled order (numpy Generator from the seed), collation of the
    nested per-view, per-scale targets, the last partial batch."""
    jc, tc = _confs(MULTI_SCALE)
    jd = jyolo.YOLODataset(root, stage="train", conf=jc)
    td = yolo.YOLODataset(root, stage="train", conf=tc)
    jl = jloader.DataLoader(jd, batch_size=2, shuffle=True, seed=5,
                            num_workers=workers)
    tl = loader.DataLoader(td, batch_size=2, shuffle=True, seed=5,
                           num_workers=workers)
    assert len(tl) == len(jl)
    for epoch in range(2):
        got, ref = list(tl), list(jl)
        assert len(got) == len(ref) == len(tl)
        for g, r in zip(got, ref):
            _assert_same(g, r, f"epoch {epoch}")
    assert got[-1]["images"].shape[0] == (len(td) % 2 or 2)


@pytest.mark.parametrize("nviews", [[3], [1, 2, 3]])
def test_assemble_matches_jax(root, tmp_path, nviews):
    """``YOLOTrainer._assemble``: the view choice (numpy Generator seeded
    seed + 1), rays on the cell grid, grid targets, padding to whole
    chunks with ignore targets, chunk anchors and n_real, over batches of
    2 scenes."""
    from pixelnerf_yolo_tpu.data import DataLoader as JDL
    from torch_parity import jax_yolo_trainer, port_yolo_trainer

    jtr, v = jax_yolo_trainer(root, tmp_path, "true")
    ttr = port_yolo_trainer(root, tmp_path, v, "true")
    jtr.nviews, ttr.nviews = nviews, nviews
    for batch in JDL(jtr.train_dataset.base_dset, batch_size=2):
        for _ in range(2):
            ref = jtr._assemble(batch)
            got = ttr._assemble(batch)
            assert len(ref) == len(got) + 1  # and JAX's scene_sharded flag
            for i, (g, r) in enumerate(zip(got, ref)):
                if isinstance(r, (int, np.integer)):
                    assert g == r, i
                else:
                    np.testing.assert_array_equal(np.asarray(g),
                                                  np.asarray(r), err_msg=i)
            rays, targets = got[4], got[5]
            assert rays.shape[2] == ttr.ray_batch_size
            assert targets.shape[:3] == rays.shape[:3]


def test_image_helpers_match_jax(rng):
    img = rng.integers(0, 255, (30, 40, 3), dtype=np.uint8)
    for size in (0, 24):
        np.testing.assert_array_equal(
            image.image_to_tensor_balanced(img, size),
            jimage.image_to_tensor_balanced(img, size))
    f = rng.normal(size=(9, 7)).astype(np.float32)
    np.testing.assert_array_equal(image.image_float_to_uint8(f),
                                  jimage.image_float_to_uint8(f))
    np.testing.assert_array_equal(image.cmap(f), jimage.cmap(f))
    mask = (rng.uniform(size=(12, 10)) > 0.7).astype(np.uint8) * 255
    np.testing.assert_array_equal(image.mask_to_tensor(mask),
                                  jimage.mask_to_tensor(mask))
    np.testing.assert_array_equal(base.mask_bbox(mask), jbase.mask_bbox(mask))
    x = rng.normal(size=(2, 3, 12, 10)).astype(np.float32)
    np.testing.assert_array_equal(base.area_resize_chw(x, (4, 5)),
                                  jbase.area_resize_chw(x, (4, 5)))


def test_parse_args_matches_jax(tmp_path, monkeypatch):
    """The same flags, conf lookup and directories as the JAX package's
    parse_args, with the training CLI's extra flags."""
    from pixelnerf_yolo_tpu.config.args import parse_args as jparse
    from pixelnerf_yolo_torch.config.args import parse_args
    from pixelnerf_yolo_torch.train.__main__ import extra_args

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PNY_PROJECT_ROOT", repo)
    argv = ["-c", "conf/exp/yolo.conf", "-D", "somewhere", "-n", "run",
            "-B", "2", "-V", "1 3", "--freeze_enc", "--gpu_id", "0 1",
            "--lr", "3e-4", "--epochs", "5"]

    def jextra(parser):  # train/train.py's flags, but for --device
        extra_args(parser)
        return parser

    targs, tconf = parse_args(extra_args, training=True, argv=argv)
    jargs, jconf = jparse(jextra, training=True, argv=argv)
    assert vars(targs) == vars(jargs)
    assert tconf._data == jconf._data
    assert targs.gpu_id == [0, 1] and targs.device == "cuda"
    assert os.path.isdir(tmp_path / "checkpoints" / "run")


def test_train_yolo_conf_is_the_bench_point():
    """``config/flagship.py::train_yolo_conf`` equals the repo's
    _DRYRUN_YOLO_CONF with the widths bench.py's train_yolo config puts
    over it."""
    from __graft_entry__ import _DRYRUN_YOLO_CONF
    from pixelnerf_yolo_torch.config.flagship import train_yolo_conf

    for dtype in ("bfloat16", "float32"):
        ref = jhocon.parse_string(_DRYRUN_YOLO_CONF)
        for key, value in (("model.compute_dtype", dtype),
                           ("model.mlp_coarse.d_hidden", 512),
                           ("model.mlp_coarse.n_blocks", 5),
                           ("model.encoder.backbone", "custom"),
                           ("model.encoder.num_layers", 4),
                           ("renderer.n_coarse", 128),
                           ("yolo.ray_batch_size", 1024)):
            ref.put(key, value)
        assert train_yolo_conf(dtype)._data == ref._data
