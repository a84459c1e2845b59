"""The benchmark's CPU tests: the checkout's root on the path, and each
cell at a size a test run holds (float32, so the program and the
reference agree to rounding)."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# per cell: (scene, conf and traffic changes) at test size
TINY = {
    "srn_views": ({"image_size": 16, "focal": 16.40625},
                  {"renderer": {}},
                  {"views_per_object": 5, "source_view": 2, "check_every": 2,
                   "warmup_views": 1, "trace": {"skip": 1, "units": 1}}),
    "yolo_train": ({"image_size": 128, "focal": 150.0},
                   {"renderer": {"n_coarse": 16},
                    "yolo": {"ray_batch_size": 16}},
                   {"scenes": 2, "views": 4, "trace": {"skip": 0, "units": 1}}),
    "yolo_detect": ({"image_size": 128, "focal": 150.0},
                    {"renderer": {"n_coarse": 16}},
                    {"check_requests": 2, "warmup_requests": 1,
                     "trace": {"skip": 0, "units": 1}}),
}


def tiny_cell(name, dtype="float32"):
    """The cell as BENCHMARK.json has it, cut to test size: 64-wide
    field, small views, float32 unless dtype says otherwise."""
    from benchmark import harness

    cell = harness.load_cell(name)
    scene, conf, traffic = TINY[name]
    cfg = copy.deepcopy(cell.config)
    cfg["scene"].update(scene)
    for section, puts in conf.items():
        cfg["conf"][section].update(puts)
    cfg["conf"]["model"]["compute_dtype"] = dtype
    for mlp in ("mlp_coarse", "mlp_fine"):
        if cfg["conf"]["model"][mlp].get("type") == "resnet":
            cfg["conf"]["model"][mlp]["d_hidden"] = 64
    cell.config = cfg
    cell.traffic = dict(cell.traffic, **traffic)
    return cell


@pytest.fixture(autouse=True)
def _threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
