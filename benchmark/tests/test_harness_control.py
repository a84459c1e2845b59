"""On the card: each cell's control comes out not correct (the program's
int8 serving path, or the reference in float8 in the program's place) at
the cell's own size, with the limits as they stand.  Run on the chip:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        benchmark/tests/test_harness_control.py
"""

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["srn_views", "yolo_train", "yolo_detect"])
def test_control_fails(name):
    import importlib

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run on the card")
    from benchmark import harness
    from benchmark.calibrate import with_puts

    harness.cache_env()
    cell = harness.load_cell(name)
    ctl = cell.limits["control"]
    cfg = with_puts(cell.config, ctl.get("conf", {}))
    kw = {"control": True} if ctl.get("reference_lowp") else {}
    mod = importlib.import_module(
        f"benchmark.drivers.{cell.traffic['driver']}")
    for seed in (4_100_000_001, 4_100_000_002, 4_100_000_003):
        drv = mod.Driver(cfg, cell.traffic, seed, "cuda", **kw)
        res = harness.execute(cell, seed, 0 if kw else 2.0, False, "cuda",
                              time.perf_counter(), driver=drv)
        assert not res["correct"], (seed, res["checks"])
