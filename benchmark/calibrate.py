"""Readings that a cell's limits are set from (not part of a run): every
number its check reads, through the harness's own run and comparison,
for the program on many seeds and for the control on a few, in one
process.

    python3 benchmark/calibrate.py --workload <name> --seeds 12 \
        --control-seeds 3 --seconds 3 [--first-seed N]

The control is the limits file's ``control``: ``{"conf": {dotted key:
value}}`` switches a path of the program on (its int8 serving mode), or
``{"reference_lowp": true}`` puts the reference, in float8, in the
program's place.  Each run prints one JSON line; the last line gives
each compared number's largest program reading, smallest control reading
and their ratio."""

import argparse
import copy
import importlib
import json
import sys
import time
from pathlib import Path


def with_puts(cfg: dict, puts: dict) -> dict:
    cfg = copy.deepcopy(cfg)
    for key, value in puts.items():
        node = cfg["conf"]
        *path, last = key.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = value
    return cfg


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--first-seed", type=int, default=3_000_000_000)
    args = p.parse_args(argv)

    from benchmark import common, harness

    harness.cache_env()
    cell = harness.load_cell(args.workload)
    mod = importlib.import_module(
        f"benchmark.drivers.{cell.traffic['driver']}")
    ctl = cell.limits.get("control", {})
    lines = []
    runs = [(False, args.first_seed + i) for i in range(args.seeds)]
    runs += [(True, args.first_seed + 1000 + i)
             for i in range(args.control_seeds)]
    for control, seed in runs:
        cfg = with_puts(cell.config, ctl.get("conf", {})) if control \
            else cell.config
        kw = {"control": True} if control and ctl.get("reference_lowp") \
            else {}
        t0 = time.perf_counter()
        nums = {}
        res = harness.execute(cell, seed, args.seconds, False, "cuda", t0,
                              driver=mod.Driver(cfg, cell.traffic, seed,
                                                "cuda", **kw),
                              readings=nums)
        line = {"seed": seed, "control": control,
                "correct": res["correct"], "units": res["attempted"],
                "seconds": time.perf_counter() - t0, **nums}
        print(json.dumps(line), flush=True)
        lines.append(line)
        common.release()
    summary = {}
    for k in cell.limits["limits"]:
        prog = [ln[k] for ln in lines if not ln["control"]]
        ctrl = [ln[k] for ln in lines if ln["control"]]
        hi, lo = max(prog), (min(ctrl) if ctrl else None)
        summary[k] = {"program_max": hi, "control_min": lo,
                      "ratio": (lo / hi if lo is not None and hi else None)}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])
    sys.exit(main())
