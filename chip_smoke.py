#!/usr/bin/env python3
"""Drive the PyTorch port (pixelnerf_yolo_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when its check fails:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: compile csrc/field_mlp_tc.cu (tensor cores: every bf16
     mode) and csrc/field_mlp_f32.cu (CUDA cores, weights and latent
     through a ring: every f32 mode) with one nvcc each, started together
     (sm_90a); print ptxas's register, spill and shared-memory report,
     every H = 512 instantiation of each (one per mode group) apart (it
     fails when one of those spills or is missing);
  3. NeRF render: the flagship NeRF render (resnet34, 64 + 16 + 16
     samples, 128x128 source views, random weights from a seed) at NS=1
     and NS=2 in bf16 and f32, through make_model / make_renderer, with the
     PE kernels (full_pe; pre_combine_pe + post_combine; bf16 on the
     tensor cores, f32 on the CUDA-core ring); then the same renders with
     model.use_fused_mlp = false, compared with the kernel's;
  4. YOLO render: the YOLO flagship at full width (ELAN backbone, 1792-d
     latent, 5 x 512 ResnetFC, 21 outputs) at NS=3 in bf16, 16,384 rays of
     a 128x128 target view, through pre_combine_pe + post_combine, then
     plain, compared; the share of samples whose latent YOLO mode keeps;
     the same render in f32, through pre_combine_pe + post_combine on
     the ring kernel (which streams the 1792-d latent), compared with
     plain;
  5. detection: encode 3 source views, YOLO rays on the 32-px cell grid of
     a 384x384 target view, YoloRenderer, decode_cells, nms_padded and
     tp_fp_fn_padded on the card against seeded target boxes; the same
     functions on the CPU must keep the same boxes; the host list NMS
     (detect/boxes.py) beside them;
  6. viewdirs render: the NeRF flagship with use_code_viewdirs = true (PE
     over [xyz, viewdirs], outside the kernels) at NS=2 in bf16 and f32 and
     at NS=1 in bf16, 16,384 rays, through pre_combine + post_combine, then
     plain, compared;
  7. kernels: each field-MLP kernel against its plain twin on the card, in
     f32 and bf16, on 40,013 rows (a ragged tail) and at the row counts of
     its launches in the renders above; pre_combine_pe and post_combine
     also at the YOLO widths (bf16 and f32), full_pe too (an NS=1 YOLO
     render's rows); times of the kernel, the twin and a cuBLAS
     addmm chain at the first render launch's rows (TIMING_REPS launches
     per variant), beside the least
     time the card needs for that work, with TFLOP/s, kernel/bound and
     kernel/library;
  8. training: the YOLO trainer at bench.py's train_yolo point
     (config/flagship.py::train_yolo_conf: ELAN, 5 x 512 ResnetFC, 128
     coarse samples, NS=3 of 4 views, one chunk of 1,024 rays) on one
     scene held in memory, in bf16 and f32, through make_model /
     make_renderer / make_trainer / train_step: one step through the
     kernels (pre_combine_pe + post_combine forward, the plain module's
     backward) and one without, from the same weights, batch, views and
     draws, compared (losses, every parameter's gradient); then each
     route's step time (median of 10 after 2 warm-up steps), peak memory
     and stage split (CUDA events: encoder, render, loss, backward,
     Adam), and the loss falling over 10 steps on one batch.
The launch counters (per wrapper and per wrapper and variant) are zeroed
just before each render path (3, 4, 5, 6) and each dtype's kernel-route
training step (8) and read just after it; a kernel of a path that never
launched fails it.

The second-to-last line is nvidia-smi's "name, power.limit"; the last is
{"ok": true, "device": {...}}.  Without a CUDA device it exits 1 and prints
no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

# published H100 SXM peaks (dense): bf16 tensor cores, f32 outside the
# tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# the Pallas call each kernel replaces
REPLACES = {
    "full_pe": "pixelnerf_yolo_tpu/ops/pallas/fused_mlp.py:412",
    "pre_combine_pe": "pixelnerf_yolo_tpu/ops/pallas/fused_mlp.py:370",
    "post_combine": "pixelnerf_yolo_tpu/ops/pallas/fused_mlp.py:458",
    "pre_combine": "pixelnerf_yolo_tpu/ops/pallas/fused_mlp.py:323",
}
KINDS = tuple(REPLACES)
SOURCES = {"cuda_core_ring": "pixelnerf_yolo_torch/csrc/field_mlp_f32.cu",
           "tensor_core": "pixelnerf_yolo_torch/csrc/field_mlp_tc.cu"}
# launches per timing: the tensor-core kernels take milliseconds, the f32
# ring kernel up to ~0.2 s at a render launch's rows
TIMING_REPS = {"cuda_core_ring": 10, "tensor_core": 20}
H, CL, NB = 512, 3, 5
# field widths: NeRF flagship (PE of xyz 42, viewdirs appended), the same
# with use_code_viewdirs (PE of [xyz, viewdirs], 78), YOLO (1792-d latent,
# 7 values x 3 anchors)
NERF = {"d_in": 42, "dL": 512, "d_out": 4}
VIEWDIRS = {"d_in": 78, "dL": 512, "d_out": 4}
YOLO = {"d_in": 42, "dL": 1792, "d_out": 21}
CHECK_ROWS = 40_013
# kernel vs twin: f32 differs in summation order only; bf16 can flip one
# bf16 rounding, which later layers carry: tolerance relative to max|ref|
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# kernel render vs plain render, max |diff| of rgb and depth in both
# passes.  f32: summation order only (measured on an H100: 0 at NS=1,
# 6e-8 at NS=2).  bf16: the plain ResnetFC rounds each product to bf16
# before its bias (flax's rounding points), the kernel after, so they
# differ by bf16 roundings (measured: at most 8.3e-3, on depth); a kernel
# that drops a layer or mixes rows differs by ~1e-1.
RENDER_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
RENDERS = [  # (source views, compute dtype, rays)
    (1, "bfloat16", 65536),
    (1, "float32", 65536),
    (2, "bfloat16", 16384),
    (2, "float32", 16384),
]
VIEWDIRS_RENDERS = [
    (2, "bfloat16", 16384),
    (2, "float32", 16384),
    (1, "bfloat16", 16384),
]
# YOLO: 16,384 rays of the 128x128 target view (the bench's 65,536 cut
# for run time); kernel vs plain aggregated prob and box values, bf16,
# relative to max(1, max|plain|): the same bf16 rounding argument as
# RENDER_TOL
YOLO_SIZE = 128
YOLO_TOL = {"bfloat16": 2e-2, "float32": 1e-5}
# detection (conf/exp/yolo.conf): anchors of the 32-px scale, thresholds
DET_SIZE, CELL = 384, 32
ANCHORS = [[0.02, 0.03], [0.04, 0.07], [0.08, 0.06]]
# thresholds; MAX_OUT covers every box, so the padded NMS truncates none
NMS_IOU, NMS_T, MATCH_IOU, MAX_OUT = 0.75, 0.45, 0.2, 512
# The YOLO scene: tests/torch_parity.py (yolo_extrinsics, yolo_scene)
# holds the same numbers for the CPU tests; a change here goes there too.
YOLO_NEAR, YOLO_FAR = 1.0, 3.0


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device time of fn over reps calls, after one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def field_mlp_of(spec, dtype, device, seed=0):
    """A ResnetFC of the given widths with random weights; fc_1
    (zero-init) gets small noise so that every block does work."""
    import torch

    from pixelnerf_yolo_torch.nn.resnetfc import ResnetFC

    g = torch.Generator().manual_seed(seed)
    mlp = ResnetFC(spec["d_in"], d_out=spec["d_out"], n_blocks=NB,
                   d_latent=spec["dL"], d_hidden=H, combine_layer=CL,
                   dtype=dtype, generator=g)
    perturb_fc1(mlp, g)
    return mlp.to(device)


def perturb_fc1(module, generator, std=0.01):
    import torch

    with torch.no_grad():
        for name, p in module.named_parameters():
            if ".fc_1." in name:
                p.add_(torch.randn(p.shape, generator=generator).to(p.device)
                       * std)


def field_work(kind: str, spec, rows: int, elt: int, w_bytes: int):
    """(flops, bytes) that a kernel's function needs: multiply-adds of its
    layers; its inputs read once, its outputs written once, its weights."""
    d_in, dL, d_out = spec["d_in"], spec["dL"], spec["d_out"]
    pre = d_in * H + CL * dL * H + 2 * CL * H * H
    post = 2 * (NB - CL) * H * H + H * d_out
    if kind == "full_pe":
        mac, io = pre + post, 6 * 4 + dL * elt + d_out * 4
    elif kind == "pre_combine_pe":
        mac, io = pre, 6 * 4 + dL * elt + H * elt
    elif kind == "pre_combine":
        mac, io = pre, d_in * elt + dL * elt + H * elt
    else:
        mac, io = post, H * elt + d_out * 4
    return 2 * mac * rows, io * rows + w_bytes


def bound(kind, spec, rows, dtype_name, elt, w_bytes):
    flops, nbytes = field_work(kind, spec, rows, elt, w_bytes)
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def library_chain(kind, *args):
    """The same MLP as one cuBLAS addmm per layer in the compute dtype (a
    yardstick only: the port never calls it).  args are the kernel's."""
    import torch

    from pixelnerf_yolo_torch.ops.field_mlp import pe_features

    def lin(a, wt, b):
        return torch.addmm(b.to(wt.dtype), a, wt)

    if kind != "post_combine":
        if kind == "pre_combine":
            zfeat, latent, w = args
        else:
            base, latent, w, code = args
            zfeat = pe_features(base, code).to(latent.dtype)
        x = lin(zfeat, w.w_in, w.b_in)
        for i in range(w.wz.shape[0]):
            x = x + lin(latent, w.wz[i], w.bz[i])
            net = lin(torch.relu(x), w.w0[i], w.b0[i])
            x = x + lin(torch.relu(net), w.w1[i], w.b1[i])
        if kind != "full_pe":
            return x
    else:
        x, w = args
    for i in range(w.w0p.shape[0]):
        net = lin(torch.relu(x), w.w0p[i], w.b0p[i])
        x = x + lin(torch.relu(net), w.w1p[i], w.b1p[i])
    return lin(torch.relu(x), w.w_out, w.b_out).float()


# kernel instantiations at each hidden width, one per group of modes:
# the pre-combine half (modes 1 and 3), the whole chain (0), the
# post-combine half (2)
MODE_GROUPS = 3


def print_kernel_reports() -> bool:
    """The ptxas lines (registers, spills, stack, shared memory) of every
    H = 512 instantiation of the tensor-core kernel and of the f32 ring
    kernel (MODE_GROUPS each), with their dynamic shared memory.  False
    when one spills or is missing: a spill there costs several times the
    kernel's time."""
    import re

    from pixelnerf_yolo_torch.ops import field_mlp as fm

    ok = True
    for lib, label, smem in (
            ("field_mlp_tc", "tensor-core kernel", fm.smem_bytes_tc(H)),
            ("field_mlp_f32", "f32 ring kernel", fm.smem_bytes_f32(H))):
        lines = fm.build_info[lib]["log"].splitlines()
        for line in lines:
            if "warning" in line.lower():
                print("  nvcc:", line.strip())
        found = 0
        for i, line in enumerate(lines):
            if "Compiling" in line and "ILi512E" in line:
                found += 1
                report = " | ".join(x.strip() for x in lines[i + 2:i + 4])
                spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                  r"spill loads", report)
                good = spill is not None and spill.groups() == ("0", "0")
                ok &= good
                print(f"{label}, H=512: {report} | dynamic shared memory "
                      f"{smem} B {'ok' if good else 'FAILED: spills'}",
                      flush=True)
        if found != MODE_GROUPS:
            print(f"FAILED: {found} ptxas reports of the H = 512 {label}, "
                  f"expected {MODE_GROUPS}")
            ok = False
    return ok


def check_kernel(kind, spec, dtype_name, rows_list, device):
    """Hold one kernel against its twin at each row count of rows_list and
    time it at rows_list[1] (the first render launch's rows).  Returns
    (ok, result)."""
    import torch

    from pixelnerf_yolo_torch.nn.code import PositionalEncoding
    from pixelnerf_yolo_torch.ops import field_mlp as fm

    cdt = getattr(torch, dtype_name)
    elt = torch.empty((), dtype=cdt).element_size()
    w = fm.stack_params(field_mlp_of(spec, cdt, device), cdt)
    w_bytes = sum(getattr(w, k).numel() * getattr(w, k).element_size()
                  for k in fm.WEIGHT_NAMES)
    code = PositionalEncoding(6, 3, 1.5, True).to(device)
    code_vd = PositionalEncoding(6, 6, 1.5, True).to(device)
    g = torch.Generator(device=device).manual_seed(1)
    kernel = getattr(fm, kind)
    plain = getattr(fm, kind + "_plain")
    variant = fm.variant(kind, cdt)

    def inputs(rows):
        base = torch.rand((rows, 6), generator=g, device=device) * 2 - 1
        base[:, 3:] /= base[:, 3:].norm(dim=-1, keepdim=True)
        base = base.contiguous()
        lat = torch.randn((rows, spec["dL"]), generator=g,
                          device=device).to(cdt)
        if kind == "post_combine":
            return (fm.pre_combine_pe_plain(base, lat, w, code).contiguous(),
                    w)
        if kind == "pre_combine":
            return (code_vd(base).to(cdt).contiguous(), lat, w)
        return (base, lat, w, code)

    ok, worst, res = True, 0.0, {}
    for i, rows in enumerate(rows_list):
        args = inputs(rows)
        got = kernel(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        scale = max(1.0, ref.float().abs().max().item())
        tol = KERNEL_TOL[dtype_name] * scale
        passed = bool(torch.isfinite(got).all()) and err <= tol
        ok &= passed
        worst = max(worst, err)
        print(f"kernel {kind:15s} {dtype_name:8s} dL={spec['dL']} "
              f"d_out={spec['d_out']} rows={rows} max_abs_err={err:.3e} "
              f"tol={tol:.3e} ({KERNEL_TOL[dtype_name]} x max|ref| "
              f"{scale:.3g}) {'ok' if passed else 'FAILED'}", flush=True)
        del got, ref
        if i == 1:  # the first render launch's rows: timed
            reps = TIMING_REPS[variant]
            ms = time_ms(lambda: kernel(*args), reps)
            plain_ms = time_ms(lambda: plain(*args), 3)
            lib_ms = time_ms(lambda: library_chain(kind, *args), reps)
            bound_ms, bound_by = bound(kind, spec, rows, dtype_name, elt,
                                       w_bytes)
            tflops = field_work(kind, spec, rows, elt, w_bytes)[0] / ms / 1e9
            print(f"  timed at rows={rows} ({variant}, {reps} launches): "
                  f"kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} "
                  f"library_ms={lib_ms:.3f} bound_ms={bound_ms:.3f} "
                  f"({bound_by}) {tflops:.1f} TFLOP/s "
                  f"kernel/bound={ms / bound_ms:.2f}x "
                  f"kernel/library={ms / lib_ms:.2f}x", flush=True)
            res.update(rows=rows, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound_ms, bound_by=bound_by, tflops=tflops,
                       variant=variant, reps=reps)
        del args
        torch.cuda.empty_cache()
    res.update(max_abs_err=worst, checked_rows=list(rows_list))
    return ok, res


def check_kernels(device, render_rows, yolo_rows):
    """Phase 7.  render_rows[kind] lists the row counts of that kernel's
    launches in the NeRF renders (coarse pass first, where its time is
    taken); yolo_rows[kind] those of a YOLO render (full_pe: at NS=1)."""
    ok, results = True, {}
    for kind in KINDS:
        spec = VIEWDIRS if kind == "pre_combine" else NERF
        for dtype_name in ("bfloat16", "float32"):
            kok, results[(kind, dtype_name)] = check_kernel(
                kind, spec, dtype_name, [CHECK_ROWS, *render_rows[kind]],
                device)
            ok &= kok
    for kind in ("full_pe", "pre_combine_pe", "post_combine"):
        kok, results[(kind, "yolo")] = check_kernel(
            kind, YOLO, "bfloat16", [CHECK_ROWS, *yolo_rows[kind]], device)
        ok &= kok
    for kind in ("full_pe", "pre_combine_pe", "post_combine"):
        kok, results[(kind, "yolo_f32")] = check_kernel(
            kind, YOLO, "float32", [CHECK_ROWS, *yolo_rows[kind]], device)
        ok &= kok
    return ok, results


# -- scenes --------------------------------------------------------------


def flagship_scene(ns, n_rays, device):
    """The bench headline scene: 128x128 source views, camera 1.3 from the
    origin, focal 120, rays of a square image at near 0.8, far 1.8."""
    import numpy as np
    import torch

    from pixelnerf_yolo_torch.utils.camera import gen_rays

    rng = np.random.default_rng(0)
    images = rng.normal(size=(1, ns, 3, 128, 128)).astype(np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32) for _ in range(ns)])
    poses[:, 2, 3] = 1.3
    poses[:, 0, 3] = np.linspace(-0.1, 0.1, ns)
    side = int(round(n_rays ** 0.5))
    rays = gen_rays(torch.from_numpy(poses[:1]).to(device), side, side,
                    torch.tensor(120.0), 0.8, 1.8).reshape(1, -1, 8)
    return images.clip(-1, 1), poses[None], np.float32(120.0), rays


def yolo_scene(ns, size, seed=0):
    """(1, NS, 3, S, S) images, (1, NS, 4, 4) world-to-camera extrinsics,
    focal (1, 2), c (1, 2) and the target camera's (1, 4, 4) extrinsic.
    The target camera sits at the origin looking down +z; its samples lie
    at world z in [near, far].  View 0 sits (near + far) / 2 behind it
    (samples on both sides of its z = 0); views 1 and 2 are the target
    camera turned 180 degrees about y (every sample at camera z < 0, where
    YOLO mode keeps the latent), the second moved sideways."""
    import numpy as np

    flip = np.diag([-1.0, 1.0, -1.0, 1.0]).astype(np.float32)
    views = [np.eye(4, dtype=np.float32), flip.copy(), flip.copy()]
    views[0][:3, 3] = [0.05, -0.03, -(YOLO_NEAR + YOLO_FAR) / 2]
    views[2][:3, 3] = [0.1, 0.05, 0.0]
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(1, ns, 3, size, size)).astype(np.float32)
    focal = np.full((1, 2), size * 0.9, np.float32)
    c = np.full((1, 2), size / 2.0, np.float32)
    return (images.clip(-1, 1), np.stack(views[:ns])[None], focal, c,
            np.eye(4, dtype=np.float32)[None])


# -- models and renders --------------------------------------------------


def build_models(device, out_scale=0.05, **conf_args):
    """The flagship model per compute dtype, weights from seed 0, and its
    renderer.  fc_1 gets small noise and lin_out is scaled by out_scale to
    put the outputs in their working range: in NeRF mode the hidden state
    of these random weights has a std of ~50 (the 512-d latents, std ~18,
    feed it), and 1/20 gives a mean density of ~1 per unit depth; in YOLO
    mode the ELAN latents give logits ~20x smaller (objectness within
    +-0.2 at 1/20, so 1 gives logits of a few units)."""
    import torch

    from pixelnerf_yolo_torch.config.flagship import flagship_conf
    from pixelnerf_yolo_torch.models import make_model
    from pixelnerf_yolo_torch.render import make_renderer

    models = {}
    for dtype_name in ("bfloat16", "float32"):
        conf = flagship_conf(compute_dtype=dtype_name, **conf_args)
        model = make_model(conf.get_config("model"), device=device, seed=0)
        perturb_fc1(model, torch.Generator().manual_seed(2))
        with torch.no_grad():
            for mlp in (model.mlp_coarse, model.mlp_fine):
                if mlp is not None:
                    mlp.lin_out.weight.mul_(out_scale)
        models[dtype_name] = (model, make_renderer(conf, device=device))
    return models


def render(models, ns, dtype_name, n_rays, device, fused: str):
    import torch

    model, renderer = models[dtype_name]
    model.use_fused_mlp = fused
    images, poses, focal, rays = flagship_scene(ns, n_rays, device)
    with torch.no_grad():
        cond = model.encode(images, poses, focal)
    g = torch.Generator(device=device).manual_seed(3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = renderer(model, cond, rays, generator=g)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def nerf_path(models, renders, device, label):
    """Kernel renders of one NeRF path; the counts are zeroed before and
    read after.  Returns (outputs, launches)."""
    from pixelnerf_yolo_torch.ops import field_mlp as fm

    fm.reset_launches()
    outs = {}
    for ns, dtype_name, n_rays in renders:
        out, sec = render(models, ns, dtype_name, n_rays, device, "auto")
        outs[(ns, dtype_name)] = out
        print(f"render {label} NS={ns} {dtype_name:8s} rays={n_rays} "
              f"kernels: {sec:.3f} s, {n_rays / sec:.1f} rays/s", flush=True)
    launches = dict(fm.variant_launches)
    print(f"launches on the {label} path: {launches}", flush=True)
    return outs, launches


def compare_plain(models, renders, kernel_out, device, label) -> bool:
    """The same renders without the kernels, compared."""
    import torch

    ok = True
    for ns, dtype_name, n_rays in renders:
        plain, sec = render(models, ns, dtype_name, n_rays, device, "false")
        got = kernel_out[(ns, dtype_name)]
        print(f"render {label} NS={ns} {dtype_name:8s} rays={n_rays} plain:   "
              f"{sec:.3f} s, {n_rays / sec:.1f} rays/s")
        tol = RENDER_TOL[dtype_name]
        for p in ("coarse", "fine"):
            for k in ("rgb", "depth"):
                a, b = got[p][k].float(), plain[p][k].float()
                good = bool(torch.isfinite(a).all()) and a.shape == b.shape
                d = (a - b).abs().flatten()
                mx, p99 = d.max().item(), d.quantile(0.99).item()
                good = good and mx <= tol
                ok &= good
                print(f"  {p:6s} {k:5s} max|diff|={mx:.3e} p99={p99:.3e} "
                      f"tol={tol} "
                      f"range=[{a.min().item():.3f}, {a.max().item():.3f}] "
                      f"{'ok' if good else 'FAILED'}")
    return ok


def yolo_render(model, renderer, n_rays, device, fused: str, size=YOLO_SIZE,
                cell=1):
    """A YOLO render of the target view's first n_rays rays on a grid of
    cell-px cells; returns (out, seconds, cond, rays)."""
    import torch

    from pixelnerf_yolo_torch.utils.camera import gen_rays_yolo

    model.use_fused_mlp = fused
    images, poses, focal, c, target = yolo_scene(3, size)
    with torch.no_grad():
        cond = model.encode(images, poses, focal, c=c)
    side = size // cell
    rays = gen_rays_yolo(torch.from_numpy(target).to(device), side, side,
                         focal[0] / cell, c[0] / cell, YOLO_NEAR,
                         YOLO_FAR).reshape(1, -1, 8)[:, :n_rays]
    g = torch.Generator(device=device).manual_seed(3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = renderer(model, cond, rays, generator=g)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, cond, rays


def kept_latent_share(model, cond, rays, n_rays=512):
    """Share of (source view, sample) pairs, over n_rays rays and 128
    depths each, whose latent YOLO mode keeps (not zeroed behind the
    camera plane, not NaN, not out of the image)."""
    import torch

    r = rays[0, :n_rays]
    z = torch.linspace(YOLO_NEAR, YOLO_FAR, 128, device=r.device)
    pts = r[:, None, :3] + z[None, :, None] * r[:, None, 3:6]
    with torch.no_grad():
        lat = model.project_latent(cond, pts.reshape(1, -1, 3))
    kept = (lat.float().abs().amax(dim=-1) > 0).float()  # (NS, N)
    return kept.mean().item(), kept.mean(dim=1).tolist()


def launched(launches: dict, mode: str, var: str | None = None) -> int:
    """Launches of ``mode`` (of its ``var`` kernel only, when given) in a
    path's counts (``field_mlp.variant_launches``)."""
    return sum(n for k, n in launches.items()
               if k.split("/")[0] == mode
               and (var is None or k.split("/")[1] == var))


def compare_yolo(got, plain, tol) -> bool:
    """Kernel vs plain YOLO render: aggregated prob and box values within
    tol x max(1, max|plain|)."""
    import torch

    ok = True
    for name, sl in (("prob", slice(0, 1)), ("boxes", slice(1, 7))):
        a, b = got[..., sl].float(), plain[..., sl].float()
        d = (a - b).abs().flatten()
        scale = max(1.0, b.abs().max().item())
        good = (bool(torch.isfinite(a).all()) and a.shape == b.shape
                and d.max().item() <= tol * scale)
        ok &= good
        print(f"  {name:5s} max|diff|={d.max().item():.3e} "
              f"p99={d.quantile(0.99).item():.3e} tol={tol * scale:.3e} "
              f"range=[{a.min().item():.3f}, {a.max().item():.3f}] "
              f"{'ok' if good else 'FAILED'}")
    return ok


def yolo_path(models, device):
    """Phase 4.  Returns (ok, bf16 launches, f32 launches, chunk rays)."""
    import torch

    from pixelnerf_yolo_torch.ops import field_mlp as fm

    model, renderer = models["bfloat16"]
    n_rays = YOLO_SIZE * YOLO_SIZE
    fm.reset_launches()
    got, sec, cond, rays = yolo_render(model, renderer, n_rays, device,
                                       "auto")
    launches = dict(fm.variant_launches)
    print(f"render YOLO NS=3 bfloat16 rays={n_rays} kernels: {sec:.3f} s, "
          f"{n_rays / sec:.1f} rays/s", flush=True)
    print(f"launches on the YOLO path: {launches}", flush=True)
    ok = (launched(launches, "pre_combine_pe", "tensor_core") > 0
          and launched(launches, "post_combine", "tensor_core") > 0)
    share, per_view = kept_latent_share(model, cond, rays)
    print(f"  latents kept (z < 0, in the image): {share:.4f} of samples; "
          f"per source view {[round(s, 4) for s in per_view]}")
    if not share > 0:
        print("FAILED: every latent of the YOLO scene is zeroed")
        ok = False
    plain, psec, _, _ = yolo_render(model, renderer, n_rays, device, "false")
    print(f"render YOLO NS=3 bfloat16 rays={n_rays} plain:   {psec:.3f} s, "
          f"{n_rays / psec:.1f} rays/s")
    ok &= compare_yolo(got, plain, YOLO_TOL["bfloat16"])
    cb = renderer.chunk_rays_for(n_rays, 3, cond.latent_flat.shape[-1])
    cb = -(-n_rays // -(-n_rays // cb))  # split evenly, as the renderer does
    del got, plain, cond
    torch.cuda.empty_cache()

    # f32 at 1792-d latents: pre_combine_pe and post_combine on the ring
    # kernel (which streams the latent)
    model32, renderer32 = models["float32"]
    fm.reset_launches()
    out32, sec32, _, _ = yolo_render(model32, renderer32, n_rays, device,
                                     "auto")
    launches32 = dict(fm.variant_launches)
    print(f"render YOLO NS=3 float32 rays={n_rays} kernels: {sec32:.3f} s, "
          f"{n_rays / sec32:.1f} rays/s; launches {launches32}", flush=True)
    good = (launched(launches32, "pre_combine_pe", "cuda_core_ring") > 0
            and launched(launches32, "post_combine", "cuda_core_ring") > 0)
    plain32, psec32, _, _ = yolo_render(model32, renderer32, n_rays, device,
                                        "false")
    print(f"render YOLO NS=3 float32 rays={n_rays} plain:   "
          f"{psec32:.3f} s, {n_rays / psec32:.1f} rays/s")
    good &= compare_yolo(out32, plain32, YOLO_TOL["float32"])
    del plain32
    if not good:
        print("FAILED: the f32 YOLO render")
    ok &= good
    del out32
    torch.cuda.empty_cache()
    return ok, launches, launches32, cb


def standard_nms(bboxes, iou_threshold, threshold, allow_empty=False):
    """``boxes.nms`` with standard greedy suppression (``map._greedy_nms``)
    in place of the reference's list quirk; the same filters."""
    import numpy as np

    from pixelnerf_yolo_torch.detect.map import _greedy_nms

    rows = [b for b in bboxes if b[1] > threshold
            and 10e-4 < b[4] < 10e4 and 10e-4 < b[5] < 10e4]
    if not rows:
        return [], 0.0, 0
    kept = _greedy_nms(np.asarray(rows, np.float64), iou_threshold)
    return kept.tolist(), max(b[1] for b in bboxes), len(rows)


def nms_check(pred, tgt, label) -> bool:
    """nms_padded and tp_fp_fn_padded on the card against the same
    functions on the CPU (the same boxes kept, the same counts), and the
    host copy detect/boxes.py beside them: with standard greedy NMS in
    place of its list NMS, the host matching must give the card's counts
    (so the two differ only by the list-NMS quirk)."""
    import torch

    from pixelnerf_yolo_torch.detect import (boxes, nms_padded,
                                             tp_fp_fn_padded)

    kept, valid = nms_padded(pred, NMS_IOU, NMS_T, MAX_OUT)
    card = tp_fp_fn_padded(tgt, pred, NMS_IOU, NMS_T, MATCH_IOU, MAX_OUT)
    torch.cuda.synchronize()
    kept_c, valid_c = nms_padded(pred.cpu(), NMS_IOU, NMS_T, MAX_OUT)
    cpu = tp_fp_fn_padded(tgt.cpu(), pred.cpu(), NMS_IOU, NMS_T, MATCH_IOU,
                          MAX_OUT)
    card, cpu = tuple(int(x) for x in card), tuple(int(x) for x in cpu)
    same = (torch.equal(valid.cpu(), valid_c)
            and torch.equal(kept.cpu(), kept_c) and card == cpu)
    t_list, p_list = tgt.cpu().tolist(), pred.cpu().tolist()
    host_kept, _, _ = boxes.nms(p_list, NMS_IOU, NMS_T)
    host = boxes.calculate_tp_fp_fn(t_list, p_list, NMS_IOU, NMS_T, MATCH_IOU)
    list_nms = boxes.nms
    boxes.nms = standard_nms
    try:
        host_std = boxes.calculate_tp_fp_fn(t_list, p_list, NMS_IOU, NMS_T,
                                            MATCH_IOU)
    finally:
        boxes.nms = list_nms
    quirk_only = host_std == card
    n_alive = int((pred[:, 1] > NMS_T).sum())
    print(f"  {label}: {pred.shape[0]} boxes, {n_alive} above {NMS_T}; "
          f"card NMS kept {int(valid.sum())}, host list NMS kept "
          f"{len(host_kept)}")
    print(f"    tp/fp/fn card {card}, CPU {cpu}, host detect/boxes.py {host} "
          f"(with standard NMS {host_std}); card == CPU: {same}; host "
          f"differs only by the list-NMS quirk: {quirk_only}")
    return same and quirk_only


def detection_path(models, device):
    """Phase 5.  Returns (ok, launches)."""
    import numpy as np
    import torch

    from pixelnerf_yolo_torch.detect import decode_cells
    from pixelnerf_yolo_torch.ops import field_mlp as fm

    model, renderer = models["bfloat16"]
    side = DET_SIZE // CELL
    fm.reset_launches()
    out, sec, _, _ = yolo_render(model, renderer, side * side, device, "auto",
                                 size=DET_SIZE, cell=CELL)
    A = renderer.num_anchors_per_scale
    anchors = torch.tensor(ANCHORS, device=device)
    pred = decode_cells(out.float().reshape(1, side, side, A, 7), anchors)[0]
    torch.cuda.synchronize()
    launches = dict(fm.variant_launches)
    print(f"detection: {side}x{side} cells x {A} anchors, render "
          f"{sec:.3f} s; launches on the detection path: {launches}",
          flush=True)
    rng = np.random.default_rng(0)

    def boxes_of(n, centers, spread, wh):
        """n [class, score, x, y, w, h] rows around the given centres."""
        xy = centers[rng.integers(0, len(centers), n)] \
            + rng.normal(size=(n, 2)) * spread
        b = np.concatenate([rng.integers(0, 2, (n, 1)),
                            rng.uniform(0, 1, (n, 1)), xy,
                            rng.uniform(*wh, size=(n, 2))], axis=1)
        return torch.from_numpy(b).float().to(device)

    # targets: 3 boxes around predicted centres and 3 random ones, score
    # 1, then 10 padding rows
    picks = pred[torch.from_numpy(rng.choice(pred.shape[0], 3,
                                             replace=False)).to(device)]
    tgt = torch.cat([boxes_of(3, picks[:, 2:4].cpu().numpy(), 0.002,
                              (0.001, 0.01)),
                     boxes_of(3, rng.uniform(0.2, 0.8, (1, 2)), 0.2,
                              (0.05, 0.3))])
    tgt[:, 1] = 1.0
    tgt = torch.cat([tgt, torch.zeros((10, 6), device=device)])
    ok = nms_check(pred, tgt, "decoded predictions")
    # random weights predict boxes far smaller than a cell, which never
    # overlap; seeded clusters of larger boxes make the NMS suppress
    clusters = rng.uniform(0.2, 0.8, (6, 2))
    ok &= nms_check(boxes_of(400, clusters, 0.01, (0.05, 0.25)),
                    torch.cat([boxes_of(8, clusters, 0.01, (0.1, 0.2)),
                               torch.zeros((8, 6), device=device)]),
                    "seeded clustered boxes")
    ok &= (launched(launches, "pre_combine_pe") > 0
           and launched(launches, "post_combine") > 0)
    if not ok:
        print("FAILED: detection")
    return ok, launches


# -- phase 8: training ----------------------------------------------------

# the trainer's operating point (config/flagship.py::train_yolo_conf):
# 256-px sources at image_scale 0.5 are 128x128 views; 4 views a scene,
# the trainer picks NS=3 of them; a 4x4 grid of 32-px cells a view, so 48
# real rays padded to one chunk of 1,024
TRAIN_SIZE, TRAIN_VIEWS, TRAIN_NS = 128, 4, 3
# [x, y, w, h, class] of each view's objects (fractions of the view)
TRAIN_BOXES = [[0.30, 0.40, 0.06, 0.05, 0], [0.70, 0.60, 0.04, 0.08, 1],
               [0.55, 0.20, 0.03, 0.03, 0]]
# kernel route vs plain route from the same weights, batch and draws: each
# reported loss relative; each parameter's gradient in relative L2.  f32:
# summation order only.  bf16: the forwards differ by bf16 roundings (the
# kernel rounds where the plain module does not, see RENDER_TOL), which
# the loss's cotangent and the backward (the same plain module on both
# routes) carry.
TRAIN_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 5e-2)}
# Under the conf's "max" aggregation each (ray, anchor) cell sends its
# prob gradient to one sample, its argmax, and a bf16 rounding that moves
# the argmax reroutes that gradient (H100 runs read 5.4e-2 and 0.11 over
# all cells).  So the bf16 step is taken again on both routes with the
# real cells whose argmax differs between the routes set to ignore (-1),
# and the gradients of the rest are held to the tolerance.  The moved
# cells are counted and held to MAX_MOVED of the real cells: a kernel that
# drops a layer or mixes rows moves most of them.  The same gradients
# under the smooth SMOOTH_AGG aggregation, over every cell, are a further
# reading held to the same tolerance.
MAX_MOVED = 0.1
SMOOTH_AGG = "soft_count"
TRAIN_WARMUP, TRAIN_TIMED, TRAIN_STAGE_STEPS, TRAIN_FIT_STEPS = 2, 10, 3, 10
STAGES = ("encoder", "render", "loss", "backward", "adam")


def train_dataset(conf):
    """One scene held in memory: seeded images, the extrinsics of
    ``yolo_scene`` (its 3 source views and the target camera) and grid
    targets from the port's ``YOLODataset._get_all_bboxes``.  No image
    files, so neither imageio nor cv2 is needed."""
    import numpy as np

    from pixelnerf_yolo_torch.data.yolo import YOLODataset

    _, poses, focal, c, target = yolo_scene(TRAIN_NS, TRAIN_SIZE)

    class MemoryYOLODataset(YOLODataset):
        def __init__(self):
            self.set_target_conf(conf)
            self.z_near, self.z_far, self.lindisp = YOLO_NEAR, YOLO_FAR, False
            rng = np.random.default_rng(4)
            images = rng.normal(size=(TRAIN_VIEWS, 3, TRAIN_SIZE,
                                      TRAIN_SIZE)).astype(np.float32)
            shift = np.array([0.05, 0.03, 0, 0, 0])
            self.item = {
                "path": "memory", "img_id": 0, "focal": focal[0],
                "c": c[0], "images": images.clip(-1, 1),
                "poses": np.concatenate([poses[0], target]),
                "bboxes": [self._get_all_bboxes(
                    (np.array(TRAIN_BOXES) + v * shift).tolist(),
                    TRAIN_SIZE, TRAIN_SIZE) for v in range(TRAIN_VIEWS)],
            }

        def __len__(self):
            return 1

        def __getitem__(self, index):
            return self.item

    return MemoryYOLODataset()


def train_args(tmp):
    import argparse

    args = argparse.Namespace(
        name="chip_smoke", resume=False, logs_path=os.path.join(tmp, "logs"),
        checkpoints_path=os.path.join(tmp, "ckpt"),
        visual_path=os.path.join(tmp, "vis"), epochs=1, lr=1e-4, gamma=1.0,
        batch_size=1, nviews=str(TRAIN_NS), freeze_enc=None,
        no_bbox_step=100000, fixed_test=None, seed=0)
    for d in (args.logs_path, args.visual_path,
              os.path.join(args.checkpoints_path, args.name)):
        os.makedirs(d, exist_ok=True)
    return args


def train_steps(trainer, batch, n, u=None, stages=False):
    """n synchronized train steps: (host ms of each, losses of each, the
    CUDA-event ms of each stage of each step when stages)."""
    import torch

    times, losses, split = [], [], []
    for _ in range(n):
        trainer.stage_events = [] if stages else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = trainer.train_step(batch, u=u)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v) for k, v in out.items()})
        if stages:
            ev = trainer.stage_events
            split.append({ev[i][0]: ev[i - 1][1].elapsed_time(ev[i][1])
                          for i in range(1, len(ev))})
    trainer.stage_events = None
    return times, losses, split


@contextlib.contextmanager
def sample_argmax(record: list):
    """Appends to record, for each chunk the YOLO renderer aggregates, the
    sample index of each (ray, anchor) cell's largest prob: the sample the
    "max" aggregation sends the prob's gradient to."""
    import torch

    from pixelnerf_yolo_torch.render import yolo as render_yolo

    aggregate = render_yolo.yolo_aggregate

    def recording(out, **kwargs):
        probs = torch.sigmoid(out[..., 0].detach().float())
        record.append(probs.argmax(dim=1))
        return aggregate(out, **kwargs)

    render_yolo.yolo_aggregate = recording
    try:
        yield
    finally:
        render_yolo.yolo_aggregate = aggregate


def ignoring(assemble, cells):
    """The trainer's ``_assemble`` with the targets of the (ray, anchor)
    cells in the boolean array cells (one scene: (rays, anchors)) set to
    ignore."""

    def masked(data):
        out = list(assemble(data))
        targets = out[5].copy()
        assert targets.shape[0] == 1, "one scene a batch"
        flat = targets.reshape(-1, *targets.shape[-2:])
        flat[cells, 0] = -1.0
        out[5] = flat.reshape(targets.shape)
        return tuple(out)

    return masked


def grad_diff(gk, gp):
    """(worst relative L2 of gk against gp over the parameters, its name,
    the parameters with a gradient on one side only)."""
    worst, worst_name, missing = 0.0, "", []
    for name, g in gp.items():
        h = gk[name]
        if g is None or h is None:
            if (g is None) != (h is None):
                missing.append(name)
            continue
        den = g.float().norm().item()
        diff = (h.float() - g.float()).norm().item()
        err = diff / den if den > 0 else (0.0 if diff == 0 else math.inf)
        if not math.isfinite(err):
            err = math.inf
        if err > worst:
            worst, worst_name = err, name
    return worst, worst_name, missing


def train_path(device):
    """Phase 8, in bf16 and f32: make_model / make_renderer / make_trainer
    at the train_yolo point; one step on the kernel route and one on the
    plain route from the same weights, batch, view choice and draws
    (losses, every parameter's gradient, launches); then step times, peak
    memory and the stage split of each route, and the loss falling over
    TRAIN_FIT_STEPS steps on one batch.  Returns (ok, launches of one
    kernel-route step per dtype, results)."""
    import shutil
    import tempfile

    import torch

    ok, step_launches, results = True, {}, {}
    tmp = tempfile.mkdtemp()
    try:
        for dtype_name in ("bfloat16", "float32"):
            good = train_one(device, dtype_name, tmp, step_launches, results)
            torch.cuda.empty_cache()
            if not good:
                print(f"FAILED: training in {dtype_name}")
            ok &= good
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return ok, step_launches, results


def train_one(device, dtype_name, tmp, step_launches, results) -> bool:
    """Phase 8 in one compute dtype (see train_path)."""
    import torch

    from pixelnerf_yolo_torch.config.flagship import train_yolo_conf
    from pixelnerf_yolo_torch.data import DataLoader
    from pixelnerf_yolo_torch.models import make_model
    from pixelnerf_yolo_torch.ops import field_mlp as fm
    from pixelnerf_yolo_torch.render import make_renderer
    from pixelnerf_yolo_torch.train import make_trainer

    conf = train_yolo_conf(dtype_name)
    model = make_model(conf.get_config("model"), device=device, seed=0)
    perturb_fc1(model, torch.Generator().manual_seed(2))
    renderer = make_renderer(conf, device=device)
    dset = train_dataset(conf)
    batch = next(iter(DataLoader(dset, batch_size=1)))
    trainer = make_trainer(train_args(os.path.join(tmp, dtype_name)),
                           conf, dset, dset, model, renderer, [TRAIN_NS],
                           device=device)
    R = conf.get_int("yolo.ray_batch_size")
    u = torch.rand((R, renderer.n_coarse), device=device,
                   generator=torch.Generator(device=device).manual_seed(5))
    init = {k: t.clone() for k, t in model.state_dict().items()}
    view_rng = trainer._rng.bit_generator.state

    def restart():
        """The initial weights and running statistics, a fresh Adam and
        the same view choice."""
        model.load_state_dict(init)
        trainer.init_opt_state(model.parameters())
        trainer._rng.bit_generator.state = view_rng

    def both_routes():
        """One step on each route from the same start: per route (losses,
        gradients, launches, each cell's argmax sample (rays, anchors))."""
        route = {}
        for fused in ("auto", "false"):
            restart()
            model.use_fused_mlp = fused
            fm.reset_launches()
            record = []
            with sample_argmax(record):
                _, losses, _ = train_steps(trainer, batch, 1, u=u)
            route[fused] = (losses[0], {
                n: None if p.grad is None else p.grad.detach().clone()
                for n, p in model.named_parameters()},
                dict(fm.variant_launches),
                torch.cat(record)[:len(real)].cpu().numpy())
        return route["auto"], route["false"]

    restart()
    A = renderer.num_anchors_per_scale
    real = trainer._assemble(batch)[5][..., 0].reshape(-1, A) != -1
    (lk, gk, launches, ak), (lp, gp, plain_launches, ap) = both_routes()
    step_launches[dtype_name] = launches
    var = fm.variant("pre_combine_pe", getattr(torch, dtype_name))
    good = (launched(launches, "pre_combine_pe", var) > 0
            and launched(launches, "post_combine", var) > 0
            and sum(plain_launches.values()) == 0)
    print(f"train {dtype_name}: launches of one kernel-route step "
          f"{launches}; plain route {plain_launches}", flush=True)
    loss_tol, grad_tol = TRAIN_TOL[dtype_name]
    loss_err = max(abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-30)
                   for k in lp)
    finite = all(math.isfinite(v) for v in lk.values())
    good &= finite and loss_err <= loss_tol
    worst, worst_name, missing = grad_diff(gk, gp)
    print(f"  kernel vs plain route, one step: losses {lk} | plain {lp}; "
          f"max relative loss diff {loss_err:.3e} (tol {loss_tol}); worst "
          f"gradient relative L2 {worst:.3e} at {worst_name} over "
          f"{len(gp)} parameters; gradient on one route only: {missing}",
          flush=True)
    moved = (ak != ap) & real
    n_moved, n_real = int(moved.sum()), int(real.sum())
    print(f"  argmax sample moved between the routes in {n_moved} of "
          f"{n_real} real (ray, anchor) cells", flush=True)
    res = {"launches": launches, "loss_err": loss_err,
           "argmax_moved": n_moved, "real_cells": n_real,
           "grad_err_all_cells": worst}
    if dtype_name == "bfloat16":
        moved_ok = n_moved <= MAX_MOVED * n_real
        print(f"  moved cells at most {MAX_MOVED} of the real ones: "
              f"{'ok' if moved_ok else 'FAILED'}", flush=True)
        good &= moved_ok
        trainer._assemble = ignoring(trainer._assemble, moved)
        (_, gk, _, _), (_, gp, _, _) = both_routes()
        del trainer._assemble
        worst, worst_name, missing = grad_diff(gk, gp)
        print(f"  the same with the {n_moved} moved cells ignored: worst "
              f"gradient relative L2 {worst:.3e} at {worst_name}; gradient "
              f"on one route only: {missing}", flush=True)
        trainer.renderer = dataclasses.replace(renderer,
                                               aggregation=SMOOTH_AGG)
        (_, gks, _, _), (_, gps, _, _) = both_routes()
        trainer.renderer = renderer
        soft, soft_name, soft_missing = grad_diff(gks, gps)
        print(f"  aggregation {SMOOTH_AGG!r}, every cell: worst gradient "
              f"relative L2 {soft:.3e} at {soft_name}; gradient on one "
              f"route only: {soft_missing}", flush=True)
        soft_ok = soft <= grad_tol and not soft_missing
        print(f"  {SMOOTH_AGG!r} gradients within {grad_tol} relative L2: "
              f"{'ok' if soft_ok else 'FAILED'}", flush=True)
        good &= soft_ok
        res["grad_err_soft"] = soft
    grads_ok = worst <= grad_tol and not missing
    print(f"  gradients within {grad_tol} relative L2: "
          f"{'ok' if grads_ok else 'FAILED'}", flush=True)
    good &= grads_ok
    res["grad_err"] = worst
    for fused, label in (("auto", "kernel"), ("false", "plain")):
        restart()
        model.use_fused_mlp = fused
        train_steps(trainer, batch, TRAIN_WARMUP)
        torch.cuda.reset_peak_memory_stats()
        times, _, _ = train_steps(trainer, batch, TRAIN_TIMED)
        peak = torch.cuda.max_memory_allocated() / 2**30
        _, _, split = train_steps(trainer, batch, TRAIN_STAGE_STEPS,
                                  stages=True)
        ms = statistics.median(times)
        stages = {k: statistics.median([s[k] for s in split])
                  for k in STAGES}
        res[label] = {"ms_median": ms, "ms_min": min(times),
                      "ms_max": max(times), "peak_gib": peak,
                      "stages_ms": stages}
        print(f"  {label:6s} route: {ms:.3f} ms/step median of "
              f"{TRAIN_TIMED} (min {min(times):.3f}, max {max(times):.3f}) "
              f"after {TRAIN_WARMUP} warm-up steps; peak memory "
              f"{peak:.2f} GiB; stage split (CUDA events, median of "
              f"{TRAIN_STAGE_STEPS} steps, ms): "
              + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()),
              flush=True)
    print(f"  kernel / plain route step time "
          f"{res['kernel']['ms_median'] / res['plain']['ms_median']:.3f}",
          flush=True)

    restart()
    model.use_fused_mlp = "auto"
    fit = []
    # a step reports the loss before its update: step 11 reads the
    # loss after 10 updates
    for _ in range(TRAIN_FIT_STEPS + 1):
        trainer._rng.bit_generator.state = view_rng
        fit += train_steps(trainer, batch, 1, u=u)[1]
    first, last = fit[0]["t"], fit[-1]["t"]
    fell = math.isfinite(last) and last < first
    print(f"  loss on one batch (same views and draws) before and after "
          f"{TRAIN_FIT_STEPS} kernel-route steps: {first:.6f} -> "
          f"{last:.6f} {'ok' if fell else 'FAILED: the loss did not fall'}",
          flush=True)
    good &= fell
    # the kernels' weights after those Adam steps (foreach on the card):
    # the cache keyed on the parameters' versions holds the new values
    cdt = getattr(torch, dtype_name)
    cached = fm.stacked_params(model.mlp_coarse, cdt)
    fresh = fm.stack_params(model.mlp_coarse, cdt)
    current = all(torch.equal(getattr(cached, k), getattr(fresh, k))
                  for k in fm.WEIGHT_NAMES)
    print(f"  kernel weights after the steps match the parameters: "
          f"{'ok' if current else 'FAILED: stale'}", flush=True)
    good &= current
    res.update(fit_first=first, fit_last=last)
    results[dtype_name] = res
    return good


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"device: {kind} | nvidia-smi name, power.limit: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    ok = run(torch.device("cuda"))
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", flush=True)
    if not ok:
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def run(device) -> bool:
    """Phases 2-8; prints the kernels line; True when every check held."""
    import torch

    from pixelnerf_yolo_torch.ops import field_mlp as fm

    t0 = time.perf_counter()
    fm.load_library()
    print(f"build: {len(fm.SOURCES)} libraries in "
          f"{time.perf_counter() - t0:.1f} s (nvcc in parallel)", flush=True)
    for name, info in fm.build_info.items():
        print(f"  {name}: {info['path']}, nvcc {info['seconds']:.1f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("    ptxas:", line.strip())
    tc_ok = print_kernel_reports()

    nerf = build_models(device)
    yolo = build_models(device, out_scale=1.0, yolo=True, backbone="custom")
    viewdirs = build_models(device, use_code_viewdirs=True)
    # warm up cuDNN and the allocator on small renders, before the counts
    render(nerf, 1, "bfloat16", 1024, device, "auto")
    yolo_render(*yolo["bfloat16"], 256, device, "auto")

    # -- the render paths, each between a reset and a read of the counts --
    nerf_out, nerf_launches = nerf_path(nerf, RENDERS, device, "NeRF")
    # bf16 and f32 at NS=1 and NS=2: every mode of the PE route in both
    # dtypes, each through its own kernel
    every = all(launched(nerf_launches, k, fm.variant(k, getattr(torch, d)))
                > 0 for k in ("full_pe", "pre_combine_pe", "post_combine")
                for d in ("bfloat16", "float32"))
    if not every:
        print("FAILED: a kernel of the NeRF path was never launched")
    ok = tc_ok and every
    ok &= compare_plain(nerf, RENDERS, nerf_out, device, "NeRF")
    del nerf_out
    torch.cuda.empty_cache()

    yok, yolo_launches, yolo32_launches, yolo_cb = yolo_path(yolo, device)
    ok &= yok
    dok, det_launches = detection_path(yolo, device)
    ok &= dok

    vd_out, vd_launches = nerf_path(viewdirs, VIEWDIRS_RENDERS, device,
                                    "viewdirs")
    good = (all(launched(vd_launches, k, fm.variant(k, getattr(torch, d)))
                > 0 for k in ("pre_combine", "post_combine")
                for d in ("bfloat16", "float32"))
            and launched(vd_launches, "full_pe") == 0
            and launched(vd_launches, "pre_combine_pe") == 0)
    if not good:
        print("FAILED: the viewdirs path must run pre_combine + "
              "post_combine and no PE kernel")
    ok &= good
    ok &= compare_plain(viewdirs, VIEWDIRS_RENDERS, vd_out, device,
                        "viewdirs")
    del vd_out
    torch.cuda.empty_cache()

    # row counts of the kernels' launches in the renders above: a chunk of
    # rays times the coarse samples, then times the fine pass's union;
    # full_pe at NS=1, pre_combine_pe / pre_combine (x 2 views) and
    # post_combine at NS=2; YOLO: a chunk x 128 samples (x 3 views), and
    # full_pe's a chunk of an NS=1 render
    r = nerf["bfloat16"][1]
    cb1 = r._chunk_rays(RENDERS[0][2], 1)
    cb2 = r._chunk_rays(RENDERS[2][2], 2)
    ks = (r.n_coarse, r.n_coarse + r.n_fine)
    render_rows = {"full_pe": [cb1 * k for k in ks],
                   "pre_combine_pe": [cb2 * k * 2 for k in ks],
                   "post_combine": [cb2 * k for k in ks],
                   "pre_combine": [cb2 * k * 2 for k in ks]}
    k_yolo = yolo["bfloat16"][1].n_coarse
    n_yolo = YOLO_SIZE * YOLO_SIZE
    cb_ns1 = yolo["bfloat16"][1].chunk_rays_for(n_yolo, 1, YOLO["dL"])
    cb_ns1 = -(-n_yolo // -(-n_yolo // cb_ns1))  # split evenly
    yolo_rows = {"full_pe": [cb_ns1 * k_yolo],
                 "pre_combine_pe": [yolo_cb * k_yolo * 3],
                 "post_combine": [yolo_cb * k_yolo]}
    del nerf, yolo, viewdirs
    torch.cuda.empty_cache()

    kok, res = check_kernels(device, render_rows, yolo_rows)
    ok &= kok

    tok, train_launches, _ = train_path(device)
    ok &= tok
    paths = {"nerf": nerf_launches, "yolo": yolo_launches,
             "yolo_f32": yolo32_launches, "detection": det_launches,
             "viewdirs": vd_launches,
             "train_step": train_launches["bfloat16"],
             "train_step_f32": train_launches["float32"]}
    timed = ("rows", "checked_rows", "max_abs_err", "ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms", "tflops")
    kernels = []
    for name in KINDS:
        b, f = res[(name, "bfloat16")], res[(name, "float32")]

        def counts(var):
            return sum(launched(p, name, var) for p in paths.values())

        entry = {
            "name": name, "route": "cuda",
            "source": SOURCES[b["variant"]], "variant": b["variant"],
            "replaces": REPLACES[name], "launches": counts(b["variant"]),
            "max_abs_err": b["max_abs_err"], "ms": b["ms"],
            "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "library_ms": b["library_ms"],
            "rows": b["rows"], "checked_rows": b["checked_rows"],
            "dtype": "bfloat16",
            "launches_by_path": {k: launched(p, name)
                                 for k, p in paths.items()},
            "tflops": b["tflops"],
            # the f32 kernel: its own source and count
            "float32": {"name": name, "route": "cuda",
                        "source": SOURCES[f["variant"]],
                        "replaces": REPLACES[name],
                        "launches": counts(f["variant"]),
                        **{k: f[k] for k in timed + ("variant",)}},
        }
        for key, label in (("yolo", "yolo_bfloat16"),
                           ("yolo_f32", "yolo_float32")):
            if (name, key) in res:
                entry[label] = {k: res[(name, key)][k] for k in timed}
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    return ok


if __name__ == "__main__":
    sys.exit(main())
