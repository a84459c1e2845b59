"""Stage attribution of the port's renders and train steps: capture a
``torch.profiler`` trace and reduce it to a per-stage table.

The port of the JAX package's ``scripts/profile_trace.py``.  The port's
hot path carries that package's cut points as ``record_function`` ranges
(``utils/profiling.py``: ``model_inference``, ``renderer_composite``,
``encoder_index``, ``resnetfc_infer``, ...) and its own spans beside them
(``PORT_SPANS``: ``train_step``, ``batch_assemble``, ``yolo_loss``,
``decode_cells``, ``nms_padded``, ...).  Capture runs an operating
point (``operating_points.py``, at ``bench.py``'s sizes) for ``--iters``
steady-state iterations after warm-up under ``torch.profiler`` and writes
a Chrome trace; the reduction gives each GPU kernel (and memcpy / memset)
to a stage:

- through its correlation id to the runtime call that launched it, and
  from there to the innermost cut-point or span range around that call
  on the same thread;
- a launch on an autograd thread in no range there goes to the range of
  the forward op that made its graph node (the ``Sequence number`` the
  forward ``cpu_op`` and the backward ``evaluate_function`` share), as
  ``bwd:<scope>``, as JAX's name stack marks a backward op
  ``transpose(jvp(<scope>))``;
- anything else to ``(no scope)``.

A trace of the CPU (``--device cpu``: no kernels) is reduced the same way
over its outermost ops, in host time.

Beside the stage table the report gives the recorder's spans of the
traced iterations (``utils/profiling.py``: count and host ms per
iteration, inclusive of their child spans) and its counters, among them
``syncs:<span>``, the host-device syncs made inside each span.

Capture then parse (on the card unless ``--device cpu``):

    python -m pixelnerf_yolo_torch.profile_trace --config yolo --iters 3

Parse a saved trace (the sidecar ``<trace>.meta.json`` capture wrote
beside it gives the iteration count, FLOPs and card):

    python -m pixelnerf_yolo_torch.profile_trace --parse-only DIR_OR_JSON

Configs: ``nerf`` (65,536 rays, NS=1), ``nerf_mv`` (16,384, NS=2), ``vd``
(16,384, NS=2, viewdirs in the PE), ``yolo`` (16,384, NS=3), and the
``train_yolo`` / ``train_nerf`` steps; ``--dtype float32`` and ``--fused
false`` select the other routes, ``--rays`` cuts a render's rays.  The
GFLOP column counts one iteration with ``utils.profiling.count_flops``
(``torch.utils.flop_counter``'s formulas: products and convolutions); a
backward's FLOPs count under ``(backward)``.  There is no GB column: no
per-kernel byte count exists without Nsight Compute.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import glob
import gzip
import json
import os
import statistics
import subprocess
import sys
import time

from .utils import profiling
from .utils.profiling import (KNOWN_SCOPES, PORT_SPANS, by_stage,
                              count_flops)

# published H100 SXM peaks (dense; NVIDIA's data sheet, at 700 W): bf16
# tensor cores, f32 outside the tensor cores
PEAK_TFLOPS = {"bfloat16": 989.0, "float32": 67.0}
RENDERS = {"nerf": (1, 65536, False), "nerf_mv": (2, 16384, False),
           "vd": (2, 16384, True), "yolo": (3, 16384, False)}
CONFIGS = tuple(RENDERS) + ("train_yolo", "train_nerf")
NO_SCOPE = "(no scope)"
# the ranges a stage is named by, innermost first
SPANS = frozenset(KNOWN_SCOPES + PORT_SPANS)
ITERATION = "profile_trace:iteration"  # the range around each iteration
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
BACKWARD_OP = "autograd::engine::evaluate_function"


# -- operating points ----------------------------------------------------------


@dataclasses.dataclass
class Point:
    """One operating point: ``step()`` runs an iteration (a render, or one
    train step; ``trainer`` is the trainer of a train point)."""

    name: str
    dtype: str
    step: object
    model: object
    trainer: object = None
    renderer: object = None
    cond: object = None
    rays: int = 0


def _nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not available"


def render_point(config, device, dtype="bfloat16", fused="auto",
                 rays=None) -> Point:
    """A render operating point: the flagship model (NeRF: resnet34, 5 x
    512 ResnetFC, 64 + 16 + 16 samples; ``yolo``: ELAN, 1792-d latent,
    128 coarse samples) with weights from seed 0, its scene from
    ``operating_points``, one render of ``rays`` rays an iteration."""
    seed = 0
    import torch

    from .config.flagship import flagship_conf
    from .models import make_model
    from .operating_points import (YOLO_FAR, YOLO_NEAR, flagship_scene,
                                   yolo_scene)
    from .render import make_renderer
    from .utils.camera import gen_rays_yolo

    ns, n_rays, viewdirs = RENDERS[config]
    n_rays = rays or n_rays
    yolo = config == "yolo"
    conf = (flagship_conf(compute_dtype=dtype, yolo=True, backbone="custom")
            if yolo else flagship_conf(compute_dtype=dtype,
                                       use_code_viewdirs=viewdirs))
    model = make_model(conf.get_config("model"), device=device, seed=seed)
    model.use_fused_mlp = fused
    renderer = make_renderer(conf, device=device)
    with torch.no_grad():
        if yolo:
            images, poses, focal, c, target = yolo_scene(ns, 128)
            cond = model.encode(images, poses, focal, c=c)
            rays_t = gen_rays_yolo(
                torch.from_numpy(target).to(device), 128, 128, focal[0],
                c[0], YOLO_NEAR, YOLO_FAR).reshape(1, -1, 8)[:, :n_rays]
        else:
            images, poses, focal, rays_t = flagship_scene(ns, n_rays, device)
            cond = model.encode(images, poses, focal)
    gen = torch.Generator(device=device).manual_seed(seed + 3)

    def step():
        return renderer(model, cond, rays_t, generator=gen)

    return Point(config, dtype, step, model, renderer=renderer, cond=cond,
                 rays=rays_t.shape[1])


def train_point(config, device, workdir, dtype="bfloat16",
                fused="auto", rays=None, puts=None) -> Point:
    """A train operating point: ``bench.py``'s ``train_yolo`` or
    ``train_nerf`` (``config/flagship.py``) on ``operating_points``'
    in-memory scene, weights from seed 0, one ``train_step`` an
    iteration.  rays: the rays of a step (``yolo.ray_batch_size`` or
    ``-R``; default the conf's 1,024 or TRAIN_NERF_RAYS); puts: {key:
    value} put into the conf (``model.remat``, ...)."""
    seed = 0
    import argparse as _argparse

    from .config.flagship import (TRAIN_NERF_RAYS, train_nerf_conf,
                                  train_yolo_conf)
    from .data import DataLoader
    from .models import make_model
    from .operating_points import (TRAIN_NS, nerf_train_dataset,
                                   train_dataset)
    from .render import make_renderer
    from .train import make_trainer

    yolo = config == "train_yolo"
    conf = (train_yolo_conf if yolo else train_nerf_conf)(dtype)
    for key, value in (puts or {}).items():
        conf.put(key, value)
    if rays and yolo:
        conf.put("yolo.ray_batch_size", rays)
    model = make_model(conf.get_config("model"), device=device, seed=seed)
    model.use_fused_mlp = fused
    renderer = make_renderer(conf, device=device)
    dset = train_dataset(conf) if yolo else nerf_train_dataset()
    ns = TRAIN_NS if yolo else 1
    args = _argparse.Namespace(
        name=config, resume=False, logs_path=os.path.join(workdir, "logs"),
        checkpoints_path=os.path.join(workdir, "ckpt"),
        visual_path=os.path.join(workdir, "vis"), epochs=1, lr=1e-4,
        gamma=1.0, batch_size=1, nviews=str(ns), freeze_enc=None,
        no_bbox_step=100000, fixed_test=None, seed=seed,
        ray_batch_size=rays or TRAIN_NERF_RAYS)
    for d in (args.logs_path, args.visual_path,
              os.path.join(args.checkpoints_path, args.name)):
        os.makedirs(d, exist_ok=True)
    trainer = make_trainer(args, conf, dset, dset, model, renderer, [ns],
                           device=device)
    batch = next(iter(DataLoader(dset, batch_size=1)))
    return Point(config, dtype, lambda: trainer.train_step(batch), model,
                 trainer)


def make_point(config, device, workdir, dtype="bfloat16", fused="auto",
               rays=None) -> Point:
    """The operating point of a config (``CONFIGS``); a train point writes
    its trainer's directories under workdir."""
    if config in RENDERS:
        return render_point(config, device, dtype, fused, rays)
    if config in CONFIGS:
        return train_point(config, device, workdir, dtype, fused)
    raise ValueError(f"unknown config {config!r}; one of {CONFIGS}")


def field_flops_per_ray(model, renderer, n_views: int) -> int:
    """``bench.py::field_flops_per_ray`` on the port model: the field
    MLP's FLOPs a ray (2 x MACs): per sample, n_views pre-combine passes
    (lin_in, then CL x (lin_z, fc_0, fc_1)) and one post-combine pass (the
    other blocks' fc_0 and fc_1, lin_out); the coarse samples through the
    coarse MLP, and with a fine MLP the coarse + fine samples of the fine
    pass through it (n_fine counts the depth samples)."""

    def mlp_flops(mlp):
        H = mlp.d_hidden
        cl = min(mlp.combine_layer, mlp.n_blocks)
        pre = 2 * (mlp.d_in * H + cl * (mlp.d_latent * H + 2 * H * H))
        post = 2 * ((mlp.n_blocks - cl) * 2 * H * H + H * mlp.d_out)
        return pre, post

    pre_c, post_c = mlp_flops(model.mlp_coarse)
    total = renderer.n_coarse * (n_views * pre_c + post_c)
    n_fine = getattr(renderer, "n_fine", 0)
    if model.mlp_fine is not None and n_fine > 0:
        pre_f, post_f = mlp_flops(model.mlp_fine)
        total += (renderer.n_coarse + n_fine) * (n_views * pre_f + post_f)
    return total


def field_rays(renderer, cond, n_rays: int) -> int:
    """The rays of one scene the renderer's field evaluates for n_rays:
    n_rays padded to a whole number of chunks."""
    ns, width = cond.num_views_per_obj, cond.latent_flat.shape[-1]
    if hasattr(renderer, "chunk_rays_for"):  # YoloRenderer's even chunks
        cb = renderer.chunk_rays_for(n_rays, ns, width, 1)
        nc = -(-n_rays // cb)
        return nc * -(-n_rays // nc)
    cb = renderer._chunk_rays(n_rays, ns, latent_width=width)
    return -(-n_rays // cb) * cb


# -- capture -------------------------------------------------------------------


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def activities(device) -> list:
    """The profiler activities of a trace: the CPU and, on the card, CUDA."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def timed(step, device, iters, mark=False) -> list:
    """ms of each of iters synchronized iterations of step() (host clock);
    mark: each inside an ``ITERATION`` range (for a trace)."""
    import torch

    out = []
    for _ in range(iters):
        _sync(device)
        t0 = time.perf_counter()
        with (torch.profiler.record_function(ITERATION) if mark
              else contextlib.nullcontext()):
            step()
            _sync(device)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def capture(point, device, iters, outdir, warmup=2) -> dict:
    """Warm-up iterations; iters iterations timed without the profiler;
    one counted by ``count_flops``; then iters iterations under
    ``torch.profiler`` (CPU and, on the card, CUDA activity), each inside
    an ``ITERATION`` range, after one more in the profiler's warm-up (its
    records dropped: late in a long process a session's first few dozen
    device records can go missing).  Writes the Chrome trace and its sidecar
    (``<trace>.meta.json``) into outdir and returns the sidecar's content
    (``launches``: the rise of ``field_mlp.variant_launches`` over the
    traced iterations) with ``trace``, the trace's path."""
    import torch

    from .ops import field_mlp as fm

    for _ in range(warmup):
        point.step()
    _sync(device)
    untraced = timed(point.step, device, iters)
    flops = by_stage(count_flops(point.step)[1])
    _sync(device)
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1)
    with torch.profiler.profile(activities=activities(device),
                                schedule=schedule) as prof:
        point.step()
        _sync(device)
        prof.step()
        before = dict(fm.variant_launches)
        traced = timed(point.step, device, iters, mark=True)
    spans = span_table(profiling.records(), iters)
    counters = {k: v / iters for k, v in profiling.counters().items()}
    launches = {k: v - before.get(k, 0)
                for k, v in fm.variant_launches.items()
                if v - before.get(k, 0)}
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, f"{point.name}_{point.dtype}.trace.json")
    prof.export_chrome_trace(path)
    dev = torch.device(device)
    meta = {"config": point.name, "dtype": point.dtype, "iters": iters,
            "flops_by_stage": flops, "launches": launches,
            "untraced_ms": untraced, "traced_ms": traced,
            "spans": spans, "counters": counters,
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
            "nvidia_smi": _nvidia_smi() if dev.type == "cuda" else None}
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f, indent=1)
    return dict(meta, trace=path)


def span_table(records, iters=1) -> dict:
    """{name: [count, host ms]} per iteration of the recorder's spans
    (``utils.profiling.records()``), each span's ms inclusive of its
    children."""
    out = collections.defaultdict(lambda: [0.0, 0.0])
    for r in records:
        if r.end:
            out[r.name][0] += 1 / iters
            out[r.name][1] += (r.end - r.start) / 1e6 / iters
    return dict(out)


# -- reduction -----------------------------------------------------------------


def find_trace(path) -> str:
    """path, or the newest Chrome trace (.json / .json.gz) under it."""
    if not os.path.isdir(path):
        return path
    hits = sorted(glob.glob(os.path.join(path, "**", "*.json*"),
                            recursive=True), key=os.path.getmtime)
    hits = [h for h in hits if not h.endswith(".meta.json")]
    if not hits:
        raise FileNotFoundError(f"no trace json under {path}")
    return hits[-1]


def load_trace(path) -> list:
    """The traceEvents of a Chrome trace (.json / .json.gz)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _innermost(intervals, queries):
    """For each (key, ts) query, the payload of the innermost interval
    (start, end, payload) of intervals[key] that contains ts, or None.
    Intervals of one key nest (ranges of one thread)."""
    out = [None] * len(queries)
    by_key = collections.defaultdict(list)
    for i, (key, _) in enumerate(queries):
        if key is not None:
            by_key[key].append(i)
    for key, idx in by_key.items():
        idx.sort(key=lambda i: queries[i][1])
        ivs = sorted(intervals.get(key, ()), key=lambda v: (v[0], -v[1]))
        stack, j = [], 0
        for i in idx:
            ts = queries[i][1]
            while j < len(ivs) and ivs[j][0] <= ts:
                while stack and stack[-1][1] < ivs[j][0]:
                    stack.pop()
                stack.append(ivs[j])
                j += 1
            while stack and stack[-1][1] < ts:
                stack.pop()
            out[i] = stack[-1][2] if stack else None
    return out


def _span(e):
    return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))


def attribute(events):
    """(device ops, their stages, "device" or "host"): each op an X event
    of a GPU kernel / memcpy / memset or, in a trace without any, an
    outermost ``cpu_op``; its stage as the module docstring says."""
    xs = [e for e in events if e.get("ph") == "X"]
    ops = [e for e in xs if e.get("cat") in DEVICE_CATS]
    where = "device"
    scopes = collections.defaultdict(list)
    for e in xs:
        if e.get("name") in SPANS and e.get("cat") == "user_annotation":
            scopes[e["tid"]].append((*_span(e), e["name"]))
    # a backward node's evaluate_function range carries the sequence number
    # of the forward op that made the node (the forward ops of one thread
    # number their nodes; "Fwd thread id" is 0 on a forward op, so the
    # number alone keys them: the forward runs on one thread)
    bwd = collections.defaultdict(list)
    fwd = {}  # sequence number -> the outermost forward op with it
    for e in xs:
        if e.get("cat") != "cpu_op":
            continue
        seq = e.get("args", {}).get("Sequence number")
        if seq is None:
            continue
        if e["name"].startswith(BACKWARD_OP):
            bwd[e["tid"]].append((*_span(e), seq))
        elif seq not in fwd or float(e["ts"]) < float(fwd[seq]["ts"]):
            fwd[seq] = e
    if ops:
        launch = {e["args"]["correlation"]: e for e in xs
                  if e.get("cat") in LAUNCH_CATS
                  and "correlation" in e.get("args", {})}
        points = [launch.get(e.get("args", {}).get("correlation")) for e in ops]
    else:
        where = "host"
        cpu = sorted((e for e in xs if e.get("cat") == "cpu_op"),
                     key=lambda e: (e["tid"], float(e["ts"]),
                                    -float(e.get("dur", 0.0))))
        ops, end = [], {}
        for e in cpu:  # outermost: not inside the previous kept op
            s, t = _span(e)
            if s >= end.get(e["tid"], -1.0):
                ops.append(e)
                end[e["tid"]] = t
        points = ops
    queries = [(p["tid"], float(p["ts"])) if p is not None else (None, 0.0)
               for p in points]
    stage = _innermost(scopes, queries)
    node = _innermost(bwd, queries)
    back = [fwd.get(k) if k is not None and s is None else None
            for k, s in zip(node, stage)]
    bq = [(f["tid"], float(f["ts"])) if f is not None else (None, 0.0)
          for f in back]
    bstage = _innermost(scopes, bq)
    stages = []
    for s, f, b in zip(stage, back, bstage):
        if s is not None:
            stages.append(s)
        elif f is not None and b is not None:
            stages.append("bwd:" + b)
        else:
            stages.append(NO_SCOPE)
    return ops, stages, where


def _union_ms(spans) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, t in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


@dataclasses.dataclass
class Reduction:
    stages: dict  # stage -> [ms, launches]
    kernels: dict  # (stage, name) -> [ms, launches]
    busy_ms: float
    wall_ms: float
    where: str
    iters: int

    @property
    def stage_ms(self) -> float:
        return sum(v[0] for v in self.stages.values())

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_ms / self.wall_ms if self.wall_ms else 0.0


def reduce(events, iters=1) -> Reduction:
    """The per-iteration stage table of a trace: ms and ops by stage and
    by (stage, op name), the ops' busy time (their union) and the traced
    window's wall time (the ``ITERATION`` ranges, else the ops' extent)."""
    ops, stages, where = attribute(events)
    by_stage = collections.defaultdict(lambda: [0.0, 0])
    by_kernel = collections.defaultdict(lambda: [0.0, 0])
    for e, s in zip(ops, stages):
        ms = float(e.get("dur", 0.0)) / 1e3 / iters
        for row in (by_stage[s], by_kernel[(s, e["name"])]):
            row[0] += ms
            row[1] += 1
    spans = [_span(e) for e in ops]
    window = [_span(e) for e in events
              if e.get("ph") == "X" and e.get("name") == ITERATION
              and e.get("cat") == "user_annotation"]
    wall = (sum(t - s for s, t in window) / 1e3 if window else
            (max(t for _, t in spans) - min(s for s, _ in spans)) / 1e3
            if spans else 0.0)
    for row in by_kernel.values():
        row[1] /= iters
    for row in by_stage.values():
        row[1] /= iters
    return Reduction(dict(by_stage), dict(by_kernel),
                     _union_ms(spans) / iters, wall / iters, where, iters)


def print_report(red: Reduction, flops=None, top=12, dtype="bfloat16",
                 card=None, out=sys.stdout, spans=None, counters=None):
    """The stage table (ms, %, launches, GFLOP, TFLOP/s per iteration),
    the top kernels by (stage, name), busy against wall time, the peaks
    the TFLOP/s compare with, and the recorder's spans (``span_table``)
    and counters per iteration where given."""
    flops = flops or {}
    total = red.stage_ms or 1.0
    p = lambda *a: print(*a, file=out)  # noqa: E731
    p(f"\n== Stage attribution ({red.where} time per iteration, "
      f"{red.iters} iterations; {red.where} busy {red.busy_ms:.3f} ms of "
      f"{red.wall_ms:.3f} ms wall, idle {100 * red.idle_share:.1f}%) ==")
    p(f"{'stage':<26}{'ms':>10}{'%':>7}{'launches':>10}{'GFLOP':>10}"
      f"{'TFLOP/s':>9}")
    for stage, (ms, n) in sorted(red.stages.items(), key=lambda kv:
                                 -kv[1][0]):
        gf = flops.get(stage)
        gcol = f"{gf / 1e9:>10.2f}" if gf is not None else f"{'-':>10}"
        tcol = (f"{gf / 1e9 / ms:>9.2f}" if gf is not None and ms
                else f"{'-':>9}")
        p(f"{stage:<26}{ms:>10.3f}{100 * ms / total:>6.1f}%{n:>10.1f}"
          f"{gcol}{tcol}")
    p(f"{'(sum)':<26}{red.stage_ms:>10.3f}")
    rest = {k: v for k, v in flops.items() if k not in red.stages}
    for stage, gf in sorted(rest.items()):
        p(f"{stage:<26}{'':>10}{'':>7}{'':>10}{gf / 1e9:>10.2f}   "
          f"(FLOPs with no row of their own"
          + ("; their kernels are the bwd: rows)" if stage == "(backward)"
             else ")"))
    p(f"GFLOP per iteration: {sum(flops.values()) / 1e9:.2f} "
      "(torch.utils.flop_counter formulas); no GB column: no per-kernel "
      "byte count without Nsight Compute")
    p(f"peaks: {PEAK_TFLOPS['bfloat16']:.0f} bf16 / "
      f"{PEAK_TFLOPS['float32']:.0f} f32 TFLOP/s (H100 SXM data sheet, "
      f"dense); this run {dtype}; card (nvidia-smi name, power.limit): "
      f"{card or 'not recorded'}")
    p(f"\n== Top {top} ops by (stage, name), ms per iteration ==")
    for (stage, name), (ms, n) in sorted(red.kernels.items(),
                                         key=lambda kv: -kv[1][0])[:top]:
        p(f"{ms:>10.3f}  {n:>7.1f}  {stage:<24}{name[:100]}")
    if spans:
        p("\n== Program spans (recorder): count and host ms per iteration, "
          "each with its children ==")
        for name, (n, ms) in sorted(spans.items(), key=lambda kv:
                                    -kv[1][1]):
            p(f"{name:<26}{n:>8.1f}{ms:>10.3f}")
    if counters:
        p("\n== Counters per iteration (syncs:<span>: host-device syncs "
          "inside the span) ==")
        for name, v in sorted(counters.items()):
            p(f"{name:<34}{v:>10.1f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="nerf", choices=CONFIGS)
    ap.add_argument("--iters", type=int, default=3,
                    help="iterations inside the trace window")
    ap.add_argument("--rays", type=int, default=None,
                    help="a render's ray count (default: the config's)")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--fused", default="auto", choices=("auto", "false"),
                    help="false: the plain field, no kernel")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--outdir", default="profile_trace_out",
                    help="where capture writes the trace")
    ap.add_argument("--parse-only", metavar="PATH", default=None,
                    help="skip capture; parse this trace (dir or json)")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    if args.parse_only:
        path = find_trace(args.parse_only)
        events = load_trace(path)
        meta = {}
        if os.path.exists(path + ".meta.json"):
            with open(path + ".meta.json") as f:
                meta = json.load(f)
        iters = meta.get("iters", args.iters)
        print(f"parsing {path} (per iteration of {iters})")
        red = reduce(events, iters)
        if not red.stages:
            sys.exit("no kernel or op events in the trace")
        print_report(red, meta.get("flops_by_stage"), args.top,
                     meta.get("dtype", args.dtype), meta.get("nvidia_smi"),
                     spans=meta.get("spans"), counters=meta.get("counters"))
        return 0

    import torch

    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            print("profile_trace: no CUDA device (pass --device cpu for a "
                  "trace of the CPU)", file=sys.stderr)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    point = make_point(args.config, args.device,
                       os.path.join(args.outdir, "work"), args.dtype,
                       args.fused, args.rays)
    meta = capture(point, args.device, args.iters, args.outdir)
    events = load_trace(meta["trace"])
    red = reduce(events, args.iters)
    print(f"{args.config} {args.dtype} fused={args.fused} on "
          f"{meta['device']}: untraced median "
          f"{statistics.median(meta['untraced_ms']):.3f} ms, traced median "
          f"{statistics.median(meta['traced_ms']):.3f} ms an iteration; "
          f"kernel launches {meta['launches']}; trace {meta['trace']}")
    print_report(red, meta["flops_by_stage"], args.top, args.dtype,
                 meta["nvidia_smi"], spans=meta["spans"],
                 counters=meta["counters"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
