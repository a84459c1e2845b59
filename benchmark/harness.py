"""The harness: finds a cell's configuration, traffic mix, limits, driver
and per-layer metric readers by the names in ``BENCHMARK.json``, runs
set-up, the measured window and the check against the reference, and
prints the result line.

A cell's files, found by name:

- ``configs/<config>.json``: the model as it is run (``conf``, in the
  reference implementation's keys), its source, what was changed and
  assumed, the weight rules (``init``);
- ``traffic/<traffic>.json``: ``driver`` (a file of ``drivers/``) and its
  parameters;
- ``limits/<workload>.json``: each number the check compares, with its
  limit;
- ``metrics/<metric>.py``: ``read(sl)``, one per-layer metric from the
  traced slice (``Slice``), or None where it finds nothing to read.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "pixelnerf_yolo_tpu")
SLICE = "bench:slice"  # the range around the traced slice


def cache_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = HERE / "_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "benchmark_file_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list
    here: Path = HERE  # the directory its files are found in


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict | None = None,
              root: Path = ROOT) -> Cell:
    """The cell's entries and files; root holds BENCHMARK.json (unless
    bench is given) and the benchmark's directory."""
    bench = bench or load_json(root / "BENCHMARK.json")
    here = root / HERE.name
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == wl["config"])
    return Cell(name, wl, load_json(root / cfg["file"]),
                load_json(here / "traffic" / f"{wl['traffic']}.json"),
                load_json(here / "limits" / f"{name}.json"),
                [m for m in bench["end_to_end"] if reports(m, name)],
                [m for m in bench["per_layer"] if reports(m, name)], here)


@dataclasses.dataclass
class Window:
    units: int
    seconds: float
    latencies: list  # seconds of each unit, from its start to its end
    trace: object = None  # trace.Reduction of the traced slice
    slice_units: int = 0


@dataclasses.dataclass
class Slice:
    """What a per-layer metric reader gets: the traced slice's reduction,
    its units of work, the driver (its counts and FLOPs) and the host
    spans the driver kept."""

    red: object
    units: int
    driver: object
    dtype: str


def _sync(device):
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def run_window(drv, seconds: float, trace: bool, device) -> Window:
    """Units until ``seconds`` have passed (none starts after), then the
    device drained.  With trace, the units [skip, skip + n) of the
    traffic's ``trace`` setting run under ``torch.profiler``."""
    import torch

    tcfg = drv.traffic.get("trace", {"skip": 1, "units": 3})
    first, last = tcfg["skip"], tcfg["skip"] + tcfg["units"]
    lat, prof, red, rng = [], None, None, None
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds or (trace and i < last):
        if trace and i == first:
            _sync(device)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if str(device).startswith("cuda"):
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(
                activities=acts, record_shapes=tcfg.get("record_shapes",
                                                        False))
            prof.__enter__()
            rng = torch.profiler.record_function(SLICE)
            rng.__enter__()
            drv.tracing = True
        s = time.perf_counter()
        drv.unit(i)
        lat.append(time.perf_counter() - s)
        i += 1
        if prof is not None and i == last:
            _sync(device)
            drv.tracing = False
            rng.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            red = _reduce(prof)
            prof = None
    drv.drain()
    return Window(i, time.perf_counter() - t0, lat, red,
                  (last - first) if red is not None else 0)


def _reduce(prof):
    from . import trace

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = load_json(Path(path))["traceEvents"]
    finally:
        os.unlink(path)
    sl = next(e for e in events if e.get("name") == SLICE
              and e.get("ph") == "X" and e.get("cat") == "user_annotation")
    s = float(sl["ts"])
    return trace.reduce(events, (s, s + float(sl["dur"])))


def device_info(device, chips: int) -> dict:
    import torch

    if not str(device).startswith("cuda"):
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(d)
                                         for d in range(chips)))}


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, driver=None, readings=None) -> dict:
    """Set-up, the window, the check: the result line as a dict (its
    ``checks`` {name: {value, limit}}).  driver: a driver object to use
    in place of the traffic's (a test's broken one, a control); readings:
    a dict given every number the check read, compared or not."""
    if driver is None:
        mod = importlib.import_module(
            f"benchmark.drivers.{cell.traffic['driver']}")
        driver = mod.Driver(cell.config, cell.traffic, seed, device)
    t_setup = time.perf_counter()
    driver.setup()
    _sync(device)
    setup_s = time.perf_counter() - t_start
    print(f"setup: {t_setup - t_start:.3f} s to the driver, "
          f"{setup_s - (t_setup - t_start):.3f} s in its set-up",
          file=sys.stderr)
    win = run_window(driver, seconds, trace, device)
    info = device_info(device, cell.workload.get("chips", 1))
    bad = forbidden_modules()
    if bad:
        raise ForbiddenImport(bad)
    result = {"correct": False, "attempted": win.units, "failed": 0,
              "metrics": {}, "device": info}
    if trace:
        red = win.trace
        if red is None:
            raise RuntimeError("the window ended before the traced slice")
        info["busy_s"], info["window_s"] = red.busy_s, red.window_s
        sl = Slice(red, win.slice_units, driver, cell.config["dtype"])
        for m in cell.per_layer:
            value = load_module(cell.here / "metrics"
                                / f"{m['name']}.py").read(sl)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        result["breakdown"] = {"device_ops": top(red.ops),
                               "idle_gaps": top(red.idle_gaps)}
    else:
        e2e = driver.end_to_end(win)
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                            "unit": m["unit"]}
    nums = driver.numbers()
    if readings is not None:
        readings.update(nums)
    checks = {k: {"value": _finite(nums.get(k, math.inf)),
                  "limit": lim} for k, lim in cell.limits["limits"].items()}
    result["correct"] = bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    result["checks"] = checks
    return result


def _finite(x) -> float:
    """x, or 1e30 where it is not finite (the line stays strict JSON)."""
    x = float(x)
    return x if math.isfinite(x) else 1e30


class ForbiddenImport(RuntimeError):
    pass


def main(argv=None, t_start=None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_env()
    cell = load_cell(args.workload)
    import torch

    chips = cell.workload.get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    readings = {}
    try:
        result = execute(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", t_start, readings=readings)
    except ForbiddenImport as e:
        print(f"error: loaded after the window: {e.args[0]}", file=sys.stderr)
        return 3
    bad = forbidden_modules()
    if bad:
        print(f"error: loaded after the window: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name in sorted(set(readings) - set(result["checks"])):
        print(f"read {name}: {readings[name]!r}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    return 0
