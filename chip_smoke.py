#!/usr/bin/env python3
"""Drive the PyTorch port (pixelnerf_yolo_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when its check fails:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: compile csrc/field_mlp_tc.cu (tensor cores: every bf16
     mode), csrc/field_mlp_f32.cu (CUDA cores, weights and latent
     through a ring: every f32 mode) and csrc/latent_gather.cu (the
     bilinear latent lookup) with one nvcc each, started together
     (sm_90a); print ptxas's register, spill and shared-memory report,
     every H = 512 instantiation of each (one per mode group) apart (it
     fails when one of those spills or is missing);
  3. NeRF render: the flagship NeRF render (resnet34, 64 + 16 + 16
     samples, 128x128 source views, random weights from a seed) at NS=1
     and NS=2 in bf16 and f32, through make_model / make_renderer, with the
     PE kernels (full_pe; pre_combine_pe + post_combine; bf16 on the
     tensor cores, f32 on the CUDA-core ring; the latent lookup through
     the gather kernel); then the same renders with
     model.use_fused_mlp = false, compared with the kernel's;
  4. YOLO render: the YOLO flagship at full width (ELAN backbone, 1792-d
     latent, 5 x 512 ResnetFC, 21 outputs) at NS=3 in bf16, 16,384 rays of
     a 128x128 target view, through pre_combine_pe + post_combine (its
     32x32 bf16 tables through the one-hot form, not the gather kernel),
     then plain, compared; the share of samples whose latent YOLO mode
     keeps; the same render in f32, through pre_combine_pe + post_combine
     on the ring kernel (which streams the 1792-d latent) and the gather
     kernel, compared with plain;
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
     render's rows); every kernel at the conv encoder's 128-d latent too
     (bf16 and f32, at phase 14's launch rows); times of the kernel, the
     twin and a cuBLAS
     addmm chain at the first render launch's rows (TIMING_REPS launches
     per variant), beside the least
     time the card needs for that work, with TFLOP/s, kernel/bound and
     kernel/library; the latent gather against the plain chain it
     replaces (bitwise) at a srn_views view's coarse and fine lookups and
     a yolo_detect request's, its time beside its bound (the output
     written once), the chain's and F.grid_sample's on the NCHW table;
  8. training: the YOLO trainer at bench.py's train_yolo point
     (config/flagship.py::train_yolo_conf: ELAN, 5 x 512 ResnetFC, 128
     coarse samples, NS=3 of 4 views, one chunk of 1,024 rays) on one
     scene held in memory, in bf16 and f32, through make_model /
     make_renderer / make_trainer / train_step: one step through the
     kernels (pre_combine_pe + post_combine forward, the plain module's
     backward) and one without, from the same weights, batch, views and
     draws, compared (losses, every parameter's gradient); then each
     route's step time (median of 10 after 2 warm-up steps), peak memory
     and stage split (one step under torch.profiler: device ms by the
     innermost program scope or span, the spans' host ms, the syncs),
     and the loss falling over 10 steps on one batch;
  9. NeRF training: the NeRF trainer at bench.py's train_nerf point
     (config/flagship.py::train_nerf_conf: the flagship NeRF model and
     renderer, 8,192 rays a step, one source view) on one SRN-format
     scene of 6 views of 128x128 held in memory (a seeded object on
     white, bbox sampling on), in bf16 and f32: one step through the
     kernels (full_pe for the coarse and the fine pass, exactly 2
     launches, the plain module's backward, gradients reaching the
     sample points through the depth samples) and one without, from the
     same weights, pixels and draws, compared; each route's step time,
     peak memory and stage split; the loss falling over 10 steps; both
     MLPs' kernel weights fresh after Adam; then one NS=2 step at 2,048
     rays on each route (pre_combine_pe + post_combine), compared;
 10. the 3-scale YOLO recipe (conf/exp/yolo_3scale.conf at the train_yolo
     point, config/flagship.py::train_yolo_3scale_conf: cells of 32, 16
     and 8 px, its anchors, cross-scale suppression, max aggregation,
     model.remat), on phase 8's scene, 3 chunks of 1,024 rays a step:
     (a) in bf16 and f32, on the kernel route and the plain route, one
     step with remat and one without from the same weights, views and
     draws, compared (losses, every gradient; bf16 with phase 8's
     ignored-cells rule), with each step's launches (remat launches each
     kernel twice as often: the replay), ms/step and peak memory, and the
     kernels' cached weights fresh after the remat steps; (b) at phase
     9's train_nerf point in f32 on the plain route, each remat_policy
     (full, block, dots) and remat_gather against no remat, with peak
     memory and time, then an f32 and a bf16 kernel-route remat step
     whose full_pe launches are 2 passes x the remat budget's chunks x 2,
     the bf16 one beside witnesses that take the replay and the chunking
     apart; (c) the recipe's metric protocol over phase 5's 384x384 scene
     (grids 12, 24 and 48 cells, 3,024 rays a view) on both routes, at an
     nms_threshold that about 150 of the random weights' boxes exceed and
     with the plain route's most confident boxes added to the ground
     truth: metric_and_map_step with the device NMS (eval_yolo's
     default), its TP/FP/FN of each view and the boxes it keeps compared
     between the routes; in f32 also calibrate_scales at [nms_threshold],
     which must equal metric_step with host matching, and the routes'
     P/R/F1, TP/FP/FN and mAP identical, TP above 0;
 11. NeRF evaluation: eval.evaluate (PSNR, SSIM) and gen_video's render
     loop on the flagship NeRF model over phase 9's scene at NS=1
     (full_pe) and NS=2 (pre_combine_pe + post_combine), bf16 and f32,
     kernel route against plain route (f32: PSNR within 1e-4 dB, SSIM
     within 1e-6);
 12. serving modes (each mode's render time, median and spread of a few
     renders, launches and peak memory printed): (a) the bf16 YOLO
     flagship (16,384 rays) on the kernel route, the plain route with the
     latent table pre-projected through lin_z (JAX's default there) and
     the plain route without it, pairwise within YOLO_TOL, with their
     chunk counts, and the gather at the one-hot form's rounding points on
     the card within 1 bf16 ulp of the CPU's; (b) early_terminate on the
     NeRF flagship (NS=1, 65,536 rays, bf16 and f32, kernel route): f = 1
     bitwise the ungated render, f = 0.25 the kept rays' fine outputs
     within RENDER_TOL of it, the rest's their coarse ones exactly, and
     full_pe's fine launches on the gated rows; (c) model.latent_int8
     (YOLO bf16 and f32, NeRF NS=1 bf16): kernel route against plain,
     and within 0.05 x max(1, max|exact|) of the render without it (JAX's
     own bound); (d) model.mlp_int8 (NeRF NS=1 bf16, plain route, no
     launch): rgb within 0.12 of the bf16 render (JAX's bound), and the
     int8 product's int32 accumulators on the card equal to the CPU's on
     a 4,096 x 512 x 512 product; (e) SPADE (NeRF, f32, 1,024 rays): the
     card within 1e-4 x max(1, max|cpu|) of the CPU, no launch; (f) the
     bf16 YOLO flagship and NeRF NS=1 (16,384 rays each) exported with
     serve.export_render, saved, loaded and run: bitwise the live render,
     with its launches (above 0);
 13. checkpoint interchange: the bf16 YOLO flagship (phases 4, 12) and
     the bf16 NeRF flagship each saved as a reference checkpoint (its
     state_dict plus the reference's non-persistent buffers), converted by
     ``python -m pixelnerf_yolo_torch.convert --torch_ckpt`` (the YOLO
     encoder, which a reference checkpoint does not carry, from --seed)
     and loaded by ``load_weights`` into a fresh model on the card; the
     converted model's kernel render (YOLO 16,384 rays through
     pre_combine_pe + post_combine; NeRF NS=1 16,384 rays through full_pe)
     bitwise the source model's; then scripts/torch_convergence.py's
     in-memory YOLO scenes built once (shapes and box count);
 14. model configurations, at the flagship's widths: (a) the conv encoder
     (backbone = conv, 128-d latent) at NS=1 (65,536 rays, full_pe) and
     NS=2 (16,384 rays, pre_combine_pe + post_combine), bf16 and f32,
     kernel route against plain at phase 3's limits; (b)
     encoder.feature_scale 0.5 and 2.0 (NS=1, 16,384 rays, full_pe),
     the same; (c) the global encoder (resnet34 beside the spatial
     resnet34, latent 128: the MLP's latent 640 wide) at NS=2, 16,384
     rays: no launch at use_fused_mlp = auto, kernel and plain settings
     alike, and card against CPU at 1,024 rays in f32 (1e-4 x max(1,
     max|cpu|)); (d) ImplicitNet (mlp type = mlp, JAX's defaults) and
     use_encoder = false, card against CPU likewise; (e) one training step
     at the train_nerf schema, 2,048 rays, for (a) at NS=1 (full_pe twice)
     and for (c) (no launch), kernel route against plain at phase 9's
     limits, with ms/step and peak memory; (f) NDC rays, card against CPU
     (1e-6);
 15. PointRend: the port's predictor (segment/, random weights from seed
     0, score threshold 0) at detectron2's sizes (shortest edge 800, at
     most 1333) on a seeded 480x640 photo, on the card against the CPU in
     f32: FPN levels within 1e-4 x max|cpu|, the same detections paired
     one to one by class, boxes within 1e-2 px, masks equal on 99.9% of
     pixels; each detect's seconds;
 16. the multi-device path (pixelnerf_yolo_torch/parallel): (a) world size
     1 over NCCL in this process: the bf16 YOLO flagship render (16,384
     rays) and NeRF NS=1 render (65,536 rays) through bind_parallel,
     bitwise the unbound renders, and one train_yolo step (f32 and bf16)
     through make_train_mesh(1) against the unbound step, as close as a
     second unbound step (bitwise where that one is); (b) two spawned
     ranks sharing the card over gloo (NCCL refuses two ranks on one
     device): the YOLO, NeRF NS=1 and viewdirs NS=2 bf16 renders of
     16,384 rays sharded over them on the kernel route against (a)'s
     world-1 renders at phase 3's limits, every kernel launched on each
     rank, and train_yolo steps at (data 1, rays 2) and (data 1, rays 1,
     model 2) against (a)'s world-1 step within phase 8's limits of its
     dtype, with each rank's ms/step and peak memory; every step of (a)
     and (b) launched pre_combine_pe and post_combine of its dtype's
     kernel;
 17. profiling (pixelnerf_yolo_torch/profile_trace.py): the nerf, yolo and
     vd renders and the train_yolo and train_nerf steps in bf16 (nerf in
     f32 too), 3 iterations each under torch.profiler, each stage table
     printed with the untraced and traced medians; held: (a) the trace's
     field-MLP kernel events equal the rise of the launch counts over the
     traced iterations, each under model_inference (printed beside it:
     where the device records sit against the iterations' synchronized
     ends, and the launches with no device record); (b) the stage times
     sum to the device busy time within 1%, (no scope) under 5% of it in
     each render; (c) count_flops of each render through the kernels
     equals the plain render's exactly, and its kernels' share equals
     bench.py's field_flops_per_ray times the rays the field evaluates
     (the chunk-padded count); update_cost_analysis of each train step
     through the kernels at least the plain step's;
 18. the port's benchmark (pixelnerf_yolo_torch/bench.py): ``python -m
     pixelnerf_yolo_torch.bench`` in a subprocess with a timeout for
     BENCH_CONFIG nerf, yolo (16,384 rays) and train_yolo at
     BENCH_ITERS=2, with the kernels built above and neither the card's
     probe nor its ceilings; each last line must be its record, naming
     this card, with a value above 0, 0 < mfu_executed <= 1.05 and the
     config's kernels (bench.KERNELS) in its kernel_launches.
The launch counters (per wrapper and per wrapper and variant) are zeroed
just before each render path (3, 4, 5, 6, 12, 13, 14, 16, 17) and each
kernel-route training step (8, 9, 10, 14, 16) or evaluation (10, 11) and
read just after it (in phase 16 (b) by each rank; in phase 18 by each
bench subprocess over its timed iterations); a kernel of a path that
never launched fails it.

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

STARTED = time.perf_counter()

# the operating points (scenes, datasets) live in the package
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from pixelnerf_yolo_torch.operating_points import (  # noqa: E402
    NERF_FAR, NERF_NEAR, NERF_TRAIN_SIZE, NERF_TRAIN_VIEWS, TRAIN_BOXES,
    TRAIN_NS, TRAIN_SIZE, TRAIN_VIEWS, YOLO_FAR, YOLO_NEAR, flagship_scene,
    look_at, nerf_train_dataset, train_dataset, yolo_scene)
from pixelnerf_yolo_torch.profile_trace import PEAK_TFLOPS  # noqa: E402

# published H100 SXM peaks (dense): the trace tool's bf16 tensor-core and
# f32 rates, HBM3 bandwidth
PEAK_FLOPS = {k: v * 1e12 for k, v in PEAK_TFLOPS.items()}
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
# the conv encoder's 128-d latent (phase 14), with and without the PE of
# the viewdirs in the z-features
CONV = {"d_in": 42, "dL": 128, "d_out": 4}
CONV_VD = {"d_in": 78, "dL": 128, "d_out": 4}
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


def check_kernels(device, render_rows, yolo_rows, conv_rows):
    """Phase 7.  render_rows[kind] lists the row counts of that kernel's
    launches in the NeRF renders (coarse pass first, where its time is
    taken); yolo_rows[kind] those of a YOLO render (full_pe: at NS=1);
    conv_rows[kind] those of the conv encoder's renders (phase 14, dL
    128)."""
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
    for kind in KINDS:
        spec = CONV_VD if kind == "pre_combine" else CONV
        for dtype_name in ("bfloat16", "float32"):
            kok, results[(kind, "conv_" + dtype_name)] = check_kernel(
                kind, spec, dtype_name, [CHECK_ROWS, *conv_rows[kind]],
                device)
            ok &= kok
    return ok, results


# the latent gather (csrc/latent_gather.cu) at the benchmark cells' lookups:
# (tables, C, points a table) of 64 x 64 bf16 tables, zeros padding, aligned
# corners: a srn_views view's coarse and fine passes (the fine pass looks up
# its 32 new samples a ray, the coarse ones' latents reused), a yolo_detect
# request
GATHER_SHAPES = {"srn_views coarse": (1, 512, 16384 * 64),
                 "srn_views fine": (1, 512, 16384 * 32),
                 "yolo_detect": (3, 1792, 256 * 128)}
GATHER_REPS = 20


def check_gather(device):
    """Phase 7, the latent gather: at each of GATHER_SHAPES the kernel
    against the plain chain it replaces (bitwise), the kernel's time beside
    its bound (the output written once at PEAK_BYTES), the chain's and
    ``F.grid_sample``'s on the NCHW table (a yardstick only: the port never
    calls it).  Returns (ok, {shape: result})."""
    import torch
    import torch.nn.functional as F

    from pixelnerf_yolo_torch.ops import grid_sample as gs
    from pixelnerf_yolo_torch.ops import latent_gather as lg

    ok, res = True, {}
    g = torch.Generator(device=device).manual_seed(7)
    for label, (B, C, N) in GATHER_SHAPES.items():
        flat = torch.randn((B, 64 * 64, C), generator=g,
                           device=device).bfloat16()
        # a tenth of the points outside the table
        grid = torch.rand((B, N, 2), generator=g, device=device) * 2.2 - 1.1

        def kernel():
            return lg.latent_gather(flat, grid, 64, 64, "zeros", True)

        def plain():
            return gs._combine(flat, gs._corners(grid, 64, 64, "zeros", True),
                               flat.dtype)

        nchw = flat.view(B, 64, 64, C).permute(0, 3, 1, 2).contiguous()
        grid4 = grid.to(flat.dtype)[:, None]

        def library():
            return F.grid_sample(nchw, grid4, mode="bilinear",
                                 padding_mode="zeros", align_corners=True)

        same = torch.equal(kernel().view(torch.int16),
                           plain().view(torch.int16))
        ok &= same
        ms = time_ms(kernel, GATHER_REPS)
        plain_ms = time_ms(plain, 3)
        lib_ms = time_ms(library, GATHER_REPS)
        bound_ms = B * N * C * flat.element_size() / PEAK_BYTES * 1e3
        print(f"kernel latent_gather bfloat16 {label}: B={B} N={N} C={C} "
              f"bitwise {'ok' if same else 'FAILED'}; kernel_ms={ms:.3f} "
              f"plain_ms={plain_ms:.3f} library_ms={lib_ms:.3f} "
              f"bound_ms={bound_ms:.3f} (bytes) kernel/bound="
              f"{ms / bound_ms:.2f}x kernel/library={ms / lib_ms:.2f}x",
              flush=True)
        res[label] = {"points": B * N, "channels": C, "bitwise": same,
                      "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": bound_ms, "bound_by": "bytes"}
        del flat, grid, nchw, grid4
        torch.cuda.empty_cache()
    return ok, res


# -- models and renders --------------------------------------------------


def build_models(device, out_scale=0.05, puts=None,
                 dtypes=("bfloat16", "float32"), **conf_args):
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
    for dtype_name in dtypes:
        conf = flagship_conf(compute_dtype=dtype_name, **conf_args)
        for key, value in (puts or {}).items():
            conf.put(key, value)
        model = make_model(conf.get_config("model"), device=device, seed=0)
        perturb_fc1(model, torch.Generator().manual_seed(2))
        with torch.no_grad():
            for mlp in (model.mlp_coarse, model.mlp_fine):
                # (an ImplicitNet field has no lin_out: left as drawn)
                if getattr(mlp, "lin_out", None) is not None:
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


GATHER = "latent_gather/cuda"  # the latent gather's key in a path's counts


def reset_counts():
    """Zero the launch counts of the field kernels and the latent gather."""
    from pixelnerf_yolo_torch.ops import field_mlp as fm
    from pixelnerf_yolo_torch.ops import latent_gather as lg

    fm.reset_launches()
    lg.launches = 0


def path_counts() -> dict:
    """The launches since reset_counts(): ``field_mlp.variant_launches``
    and, under GATHER, the latent gather's."""
    from pixelnerf_yolo_torch.ops import field_mlp as fm
    from pixelnerf_yolo_torch.ops import latent_gather as lg

    return {**fm.variant_launches, GATHER: lg.launches}


def nerf_path(models, renders, device, label):
    """Kernel renders of one NeRF path; the counts are zeroed before and
    read after.  Returns (outputs, launches)."""
    reset_counts()
    outs = {}
    for ns, dtype_name, n_rays in renders:
        out, sec = render(models, ns, dtype_name, n_rays, device, "auto")
        outs[(ns, dtype_name)] = out
        print(f"render {label} NS={ns} {dtype_name:8s} rays={n_rays} "
              f"kernels: {sec:.3f} s, {n_rays / sec:.1f} rays/s", flush=True)
    launches = path_counts()
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
    path's counts (``field_mlp.variant_launches``, or path_counts())."""
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

    model, renderer = models["bfloat16"]
    n_rays = YOLO_SIZE * YOLO_SIZE
    reset_counts()
    got, sec, cond, rays = yolo_render(model, renderer, n_rays, device,
                                       "auto")
    launches = path_counts()
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
    reset_counts()
    out32, sec32, _, _ = yolo_render(model32, renderer32, n_rays, device,
                                     "auto")
    launches32 = path_counts()
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

    model, renderer = models["bfloat16"]
    side = DET_SIZE // CELL
    reset_counts()
    out, sec, _, _ = yolo_render(model, renderer, side * side, device, "auto",
                                 size=DET_SIZE, cell=CELL)
    A = renderer.num_anchors_per_scale
    anchors = torch.tensor(ANCHORS, device=device)
    pred = decode_cells(out.float().reshape(1, side, side, A, 7), anchors)[0]
    torch.cuda.synchronize()
    launches = path_counts()
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

# the trainer's operating point (config/flagship.py::train_yolo_conf;
# the scene: operating_points.train_dataset): 256-px sources at
# image_scale 0.5 are 128x128 views; 4 views a scene, the trainer picks
# NS=3 of them; a 4x4 grid of 32-px cells a view, so 48 real rays padded
# to one chunk of 1,024
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
TRAIN_WARMUP, TRAIN_TIMED, TRAIN_FIT_STEPS = 2, 10, 10


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


def train_steps(trainer, batch, n, **step_args):
    """n synchronized train steps (step_args: the pre-made draws, u= or
    draws=): (host ms of each, losses of each)."""
    import torch

    times, losses = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = trainer.train_step(batch, **step_args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v) for k, v in out.items()})
    return times, losses


def stage_split(trainer, batch, tmp, **step_args):
    """The stage split of one train step under ``torch.profiler``:
    (device ms of each stage, by the innermost program scope or span
    around each launch, ``bwd:<scope>`` in the backward, as
    ``profile_trace.reduce`` gives them; the recorder's spans, host ms
    each with its children; its counters, ``syncs:<span>`` among them)."""
    import torch

    from pixelnerf_yolo_torch import profile_trace as pt
    from pixelnerf_yolo_torch.utils import profiling

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=pt.activities("cuda")) as prof:
        with torch.profiler.record_function(pt.ITERATION):
            trainer.train_step(batch, **step_args)
            torch.cuda.synchronize()
    path = os.path.join(tmp, "stage_split.trace.json")
    prof.export_chrome_trace(path)
    red = pt.reduce(pt.load_trace(path))
    os.remove(path)
    spans = pt.span_table(profiling.records())
    return ({k: ms for k, (ms, _) in red.stages.items()},
            {k: ms for k, (_, ms) in spans.items()}, profiling.counters())


def print_split(split):
    """Print stage_split's tables."""
    stages, spans, counters = split
    print("  stage split of one profiled step (device ms by innermost "
          "scope or span, profile_trace): " + ", ".join(
              f"{k} {v:.3f}" for k, v in sorted(stages.items(),
                                                key=lambda kv: -kv[1])),
          flush=True)
    print("  spans (host ms, with their children): " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(spans.items(),
                                          key=lambda kv: -kv[1]))
          + "; counters: " + ", ".join(f"{k} {v}" for k, v in
                                       sorted(counters.items())),
          flush=True)


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
            reset_counts()
            record = []
            with sample_argmax(record):
                _, losses = train_steps(trainer, batch, 1, u=u)
            route[fused] = (losses[0], {
                n: None if p.grad is None else p.grad.detach().clone()
                for n, p in model.named_parameters()},
                path_counts(),
                torch.cat(record)[:len(real)].cpu().numpy())
        return route["auto"], route["false"]

    restart()
    A = renderer.num_anchors_per_scale
    real = trainer._assemble(batch)[5][..., 0].reshape(-1, A) != -1
    (lk, gk, launches, ak), (lp, gp, plain_launches, ap) = both_routes()
    step_launches[dtype_name] = launches
    var = fm.variant("pre_combine_pe", getattr(torch, dtype_name))
    # every lookup of a step records a gradient: no gather on either route
    good = (launched(launches, "pre_combine_pe", var) > 0
            and launched(launches, "post_combine", var) > 0
            and launches[GATHER] == 0
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
        times, _ = train_steps(trainer, batch, TRAIN_TIMED)
        peak = torch.cuda.max_memory_allocated() / 2**30
        split = stage_split(trainer, batch, tmp)
        ms = statistics.median(times)
        res[label] = {"ms_median": ms, "ms_min": min(times),
                      "ms_max": max(times), "peak_gib": peak,
                      "stages_ms": split[0], "spans_ms": split[1]}
        print(f"  {label:6s} route: {ms:.3f} ms/step median of "
              f"{TRAIN_TIMED} (min {min(times):.3f}, max {max(times):.3f}) "
              f"after {TRAIN_WARMUP} warm-up steps; peak memory "
              f"{peak:.2f} GiB", flush=True)
        print_split(split)
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

# -- phase 9: NeRF training -----------------------------------------------

# the trainer's operating point (config/flagship.py::train_nerf_conf,
# bench.py's train_nerf): one SRN-format scene of 6 views of 128x128, one
# source view a step, 8,192 rays of the scene a step, inside the views'
# object boxes (bbox sampling); SRN cars' z bounds
# (operating_points.nerf_train_dataset).  Then one NS=2 step
# (conf/default_mv.conf's two source views) at 2,048 rays.
NERF_NS2_RAYS = 2048
# kernel route vs plain route, the same limits as phase 8 (PERF.md §2):
# f32 summation order only; bf16 the kernels' roundings, which also move
# the coarse weights the importance samples follow (a smooth move: the
# inverse CDF is continuous)
NERF_TRAIN_TOL = TRAIN_TOL


def nerf_train_path(device):
    """Phase 9, in bf16 and f32 (see nerf_train_one).  Returns (ok,
    launches of one kernel-route step per path, results)."""
    import shutil
    import tempfile

    import torch

    ok, step_launches, results = True, {}, {}
    tmp = tempfile.mkdtemp()
    try:
        for dtype_name in ("bfloat16", "float32"):
            good = nerf_train_one(device, dtype_name, tmp, step_launches,
                                  results)
            torch.cuda.empty_cache()
            if not good:
                print(f"FAILED: NeRF training in {dtype_name}")
            ok &= good
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return ok, step_launches, results


def nerf_trainer(device, dtype_name, tmp, ns, rays, puts=None):
    """make_model / make_renderer / make_trainer at the train_nerf point
    with ns source views and rays a step (and the conf keys of puts set);
    the model's weights from seed 0 with fc_1 perturbed and lin_out scaled
    as the renders' (build_models)."""
    import torch

    from pixelnerf_yolo_torch.config.flagship import train_nerf_conf
    from pixelnerf_yolo_torch.data import DataLoader
    from pixelnerf_yolo_torch.models import make_model
    from pixelnerf_yolo_torch.render import make_renderer
    from pixelnerf_yolo_torch.train import make_trainer

    conf = train_nerf_conf(dtype_name)
    for key, value in (puts or {}).items():
        conf.put(key, value)
    model = make_model(conf.get_config("model"), device=device, seed=0)
    perturb_fc1(model, torch.Generator().manual_seed(2))
    with torch.no_grad():
        for mlp in (model.mlp_coarse, model.mlp_fine):
            mlp.lin_out.weight.mul_(0.05)
    renderer = make_renderer(conf, device=device)
    dset = nerf_train_dataset()
    batch = next(iter(DataLoader(dset, batch_size=1)))
    args = train_args(os.path.join(tmp, f"{dtype_name}_ns{ns}"))
    args.nviews, args.ray_batch_size = str(ns), rays
    trainer = make_trainer(args, conf, dset, dset, model, renderer, [ns],
                           device=device)
    draws = renderer.draw(rays, torch.Generator(device=device).manual_seed(5),
                          device, train=True)
    return trainer, model, batch, draws


def nerf_both_routes(trainer, model, batch, draws, restart):
    """One step on each route from the same weights, pixels and draws:
    per route (losses, gradients, launches)."""
    import torch

    from pixelnerf_yolo_torch.ops import field_mlp as fm

    route = {}
    for fused in ("auto", "false"):
        restart()
        model.use_fused_mlp = fused
        fm.reset_launches()
        _, losses = train_steps(trainer, batch, 1, draws=draws)
        route[fused] = (losses[0], {
            n: None if p.grad is None else p.grad.detach().clone()
            for n, p in model.named_parameters()},
            dict(fm.variant_launches))
        torch.cuda.synchronize()
    return route["auto"], route["false"]


def nerf_agreement(label, dtype_name, kernel, plain) -> tuple[bool, dict]:
    """Losses (relative) and every gradient (relative L2), kernel route
    against plain, to NERF_TRAIN_TOL."""
    (lk, gk, _), (lp, gp, _) = kernel, plain
    loss_tol, grad_tol = NERF_TRAIN_TOL[dtype_name]
    loss_err = max(abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-30) for k in lp)
    finite = all(math.isfinite(v) for v in lk.values())
    worst, worst_name, missing = grad_diff(gk, gp)
    good = (finite and set(lk) == {"rc", "rf", "t"} and loss_err <= loss_tol
            and worst <= grad_tol and not missing)
    print(f"  {label}: kernel vs plain route, one step: losses {lk} | plain "
          f"{lp}; max relative loss diff {loss_err:.3e} (tol {loss_tol}); "
          f"worst gradient relative L2 {worst:.3e} at {worst_name} (tol "
          f"{grad_tol}) over {len(gp)} parameters; gradient on one route "
          f"only: {missing} {'ok' if good else 'FAILED'}", flush=True)
    return good, {"loss_err": loss_err, "grad_err": worst,
                  "grad_err_at": worst_name}


def nerf_train_one(device, dtype_name, tmp, step_launches, results) -> bool:
    """Phase 9 in one compute dtype: at the train_nerf point (NS=1, 8,192
    rays, bbox sampling), one step on the kernel route (full_pe forward
    for the coarse and the fine pass, the plain module's backward) and one
    on the plain route from the same weights, pixels and draws, compared,
    with the launches of the kernel-route step; each route's step time,
    peak memory and stage split; the loss falling over TRAIN_FIT_STEPS
    steps on one batch and both MLPs' kernel weights fresh after them.
    Then one NS=2 step at NERF_NS2_RAYS rays on each route (pre_combine_pe
    and post_combine), compared."""
    import torch

    from pixelnerf_yolo_torch.config.flagship import TRAIN_NERF_RAYS
    from pixelnerf_yolo_torch.ops import field_mlp as fm

    cdt = getattr(torch, dtype_name)
    suffix = "" if dtype_name == "bfloat16" else "_f32"
    trainer, model, batch, draws = nerf_trainer(device, dtype_name, tmp, 1,
                                                TRAIN_NERF_RAYS)
    init = {k: t.clone() for k, t in model.state_dict().items()}
    pixel_rng = trainer._rng.bit_generator.state

    def restart():
        """The initial weights and running statistics, a fresh Adam and
        the same views and pixels."""
        model.load_state_dict(init)
        trainer.init_opt_state(model.parameters())
        trainer._rng.bit_generator.state = pixel_rng

    kernel, plain = nerf_both_routes(trainer, model, batch, draws, restart)
    launches = kernel[2]
    step_launches["train_nerf" + suffix] = launches
    var = fm.variant("full_pe", cdt)
    good = (launched(launches, "full_pe", var) == 2
            and launched(launches, "pre_combine_pe") == 0
            and launched(launches, "post_combine") == 0
            and sum(plain[2].values()) == 0)
    print(f"train NeRF {dtype_name}: launches of one kernel-route step "
          f"{launches} (full_pe must launch twice, coarse and fine); plain "
          f"route {plain[2]} {'ok' if good else 'FAILED'}", flush=True)
    agree, res = nerf_agreement(f"NS=1, {TRAIN_NERF_RAYS} rays", dtype_name,
                                kernel, plain)
    good &= agree
    res["launches"] = launches
    del kernel, plain

    for fused, label in (("auto", "kernel"), ("false", "plain")):
        restart()
        model.use_fused_mlp = fused
        train_steps(trainer, batch, TRAIN_WARMUP, draws=draws)
        torch.cuda.reset_peak_memory_stats()
        times, _ = train_steps(trainer, batch, TRAIN_TIMED, draws=draws)
        peak = torch.cuda.max_memory_allocated() / 2**30
        split = stage_split(trainer, batch, tmp, draws=draws)
        ms = statistics.median(times)
        res[label] = {"ms_median": ms, "ms_min": min(times),
                      "ms_max": max(times), "peak_gib": peak,
                      "stages_ms": split[0], "spans_ms": split[1]}
        print(f"  {label:6s} route: {ms:.3f} ms/step median of "
              f"{TRAIN_TIMED} (min {min(times):.3f}, max {max(times):.3f}) "
              f"after {TRAIN_WARMUP} warm-up steps; peak memory "
              f"{peak:.2f} GiB", flush=True)
        print_split(split)
    print(f"  kernel / plain route step time "
          f"{res['kernel']['ms_median'] / res['plain']['ms_median']:.3f}",
          flush=True)

    restart()
    model.use_fused_mlp = "auto"
    fit = []
    # a step reports the loss before its update: step 11 reads the
    # loss after 10 updates
    for _ in range(TRAIN_FIT_STEPS + 1):
        trainer._rng.bit_generator.state = pixel_rng
        fit += train_steps(trainer, batch, 1, draws=draws)[1]
    first, last = fit[0]["t"], fit[-1]["t"]
    fell = math.isfinite(last) and last < first
    print(f"  loss on one batch (same pixels and draws) before and after "
          f"{TRAIN_FIT_STEPS} kernel-route steps: {first:.6f} -> "
          f"{last:.6f} {'ok' if fell else 'FAILED: the loss did not fall'}",
          flush=True)
    good &= fell
    # both MLPs' cached kernel weights after those Adam steps
    current = all(
        torch.equal(getattr(fm.stacked_params(mlp, cdt), k),
                    getattr(fm.stack_params(mlp, cdt), k))
        for mlp in (model.mlp_coarse, model.mlp_fine)
        for k in fm.WEIGHT_NAMES)
    print(f"  kernel weights of mlp_coarse and mlp_fine after the steps "
          f"match the parameters: {'ok' if current else 'FAILED: stale'}",
          flush=True)
    good &= current
    res.update(fit_first=first, fit_last=last)
    del trainer, model, init
    torch.cuda.empty_cache()

    # NS=2: the pre_combine_pe + view mean + post_combine route
    trainer, model, batch, draws = nerf_trainer(device, dtype_name, tmp, 2,
                                                NERF_NS2_RAYS)
    init = {k: t.clone() for k, t in model.state_dict().items()}
    pixel_rng = trainer._rng.bit_generator.state
    kernel, plain = nerf_both_routes(trainer, model, batch, draws, restart)
    launches2 = kernel[2]
    step_launches["train_nerf_ns2" + suffix] = launches2
    var = fm.variant("pre_combine_pe", cdt)
    good2 = (launched(launches2, "pre_combine_pe", var) == 2
             and launched(launches2, "post_combine", var) == 2
             and launched(launches2, "full_pe") == 0
             and sum(plain[2].values()) == 0)
    print(f"train NeRF NS=2 {dtype_name}: launches of one kernel-route step "
          f"{launches2}; plain route {plain[2]} "
          f"{'ok' if good2 else 'FAILED'}", flush=True)
    agree2, res2 = nerf_agreement(f"NS=2, {NERF_NS2_RAYS} rays", dtype_name,
                                  kernel, plain)
    good &= good2 and agree2
    res2["launches"] = launches2
    res["ns2"] = res2
    results[dtype_name] = res
    return good


# -- phase 10: the 3-scale YOLO recipe ------------------------------------

# conf/exp/yolo_3scale.conf at the train_yolo point
# (config/flagship.py::train_yolo_3scale_conf): cells of 32, 16 and 8 px,
# so phase 8's 128x128 views have 4x4, 8x8 and 16x16 grids; each scale's
# rays (48, 192, 768 of the 3 views) padded to a chunk of 1,024, 3 chunks
# a step.  Remat against no remat on one route: the same forward (the
# replay runs the same kernels on the same inputs), so losses to 1e-6
# relative; gradients in relative L2, f32 1e-5 (the gather's atomics),
# bf16 5e-2 with phase 8's ignored-cells rule (MAX_MOVED): where remat's
# budget splits the rays into more chunks, the chunks' bf16 latent
# gradients are summed in bf16 (1.7e-2 at the train_nerf point on the
# H100)
REMAT_TOL = {"float32": (1e-6, 1e-5), "bfloat16": (1e-6, 5e-2)}
MS_TIMED = 2
# (remat_policy, remat_gather) at phase 9's train_nerf point, f32, plain
POLICIES = [("full", False), ("block", False), ("dots", False),
            ("", True)]
# evaluation: phase 5's scene (3 sources and the target camera, 384x384)
# as one 4-view item; the metric protocol's views [0, 2, 3], each a
# destination on grids of 12x12, 24x24 and 48x48 cells (3,024 rays)
MS_EVAL_SIZE = 384
# the evaluation's ground truth gains each destination's most confident
# plain-route boxes, so that TP is not 0 under random weights; the boxes
# the routes' f32 device NMS keeps agree to EVAL_BOX_TOL (relative to
# max(1, |value|))
EVAL_GT_ADDED, EVAL_BOX_TOL = 4, 1e-4
# NeRF evaluation (phase 11): phase 9's scene; eval's default ray batch;
# the orbit's frames; kernel against plain route, f32: PSNR in dB, SSIM
EVAL_RAYS, VIDEO_FRAMES = 50000, 3
EVAL_TOL = {"psnr": 1e-4, "ssim": 1e-6}


def multiscale_path(device):
    """Phase 10: (a) the recipe's training step with and without remat on
    each route in bf16 and f32; (b) the remat policies at the train_nerf
    point, and a kernel-route remat step there; (c) the evaluation of the
    recipe (metric_and_map_step, calibrate_scales, metric_step).  Returns
    (ok, launches by path, results)."""
    import shutil
    import tempfile

    import torch

    ok, launches, results = True, {}, {}
    tmp = tempfile.mkdtemp()
    try:
        for dtype_name in ("bfloat16", "float32"):
            good = multiscale_train_one(device, dtype_name, tmp, launches,
                                        results)
            torch.cuda.empty_cache()
            if not good:
                print(f"FAILED: 3-scale training in {dtype_name}")
            ok &= good
        good = remat_policies(device, tmp, launches, results)
        torch.cuda.empty_cache()
        if not good:
            print("FAILED: remat at the train_nerf point")
        ok &= good
        for dtype_name in ("bfloat16", "float32"):
            good = multiscale_eval(device, dtype_name, tmp, launches,
                                   results)
            torch.cuda.empty_cache()
            if not good:
                print(f"FAILED: 3-scale evaluation in {dtype_name}")
            ok &= good
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return ok, launches, results


def multiscale_trainer(device, conf, tmp, size=TRAIN_SIZE):
    """make_model / make_renderer / make_trainer on the conf over
    train_dataset at size; weights from seed 0 with fc_1 perturbed."""
    import torch

    from pixelnerf_yolo_torch.data import DataLoader
    from pixelnerf_yolo_torch.models import make_model
    from pixelnerf_yolo_torch.render import make_renderer
    from pixelnerf_yolo_torch.train import make_trainer

    model = make_model(conf.get_config("model"), device=device, seed=0)
    perturb_fc1(model, torch.Generator().manual_seed(2))
    renderer = make_renderer(conf, device=device)
    dset = train_dataset(conf, size)
    batch = next(iter(DataLoader(dset, batch_size=1)))
    trainer = make_trainer(train_args(tmp), conf, dset, dset, model,
                           renderer, [TRAIN_NS], device=device)
    return trainer, model, renderer, batch


def multiscale_train_one(device, dtype_name, tmp, launches, results) -> bool:
    """Phase 10 (a) in one dtype: from the same weights, views and draws,
    one step with remat and one without on the kernel route and on the
    plain route; remat against no remat on each route; the launches of
    each kernel-route step (remat replays the forward, kernels included);
    then MS_TIMED timed steps of each (ms/step, peak memory); the kernels'
    cached weights fresh after the remat steps' Adam updates."""
    import torch

    from pixelnerf_yolo_torch.config.flagship import train_yolo_3scale_conf
    from pixelnerf_yolo_torch.ops import field_mlp as fm

    conf = train_yolo_3scale_conf(dtype_name)
    trainer, model, renderer, batch = multiscale_trainer(
        device, conf, os.path.join(tmp, "ms_" + dtype_name))
    init = {k: t.clone() for k, t in model.state_dict().items()}
    view_rng = trainer._rng.bit_generator.state
    assembled = trainer._assemble(batch)
    trainer._rng.bit_generator.state = view_rng
    A = renderer.num_anchors_per_scale
    real = assembled[5][..., 0].reshape(-1, A) != -1
    n_chunks, chunk = assembled[4].shape[1:3]
    u = torch.rand((n_chunks * chunk, renderer.n_coarse),
                   device=device,
                   generator=torch.Generator(device=device).manual_seed(5))

    def step(fused, remat, timed=0):
        """One step from the initial state (losses, gradients, launches,
        each cell's argmax sample), and with timed, that many more steps'
        (ms, peak GiB)."""
        model.load_state_dict(init)
        trainer.init_opt_state(model.parameters())
        trainer._rng.bit_generator.state = view_rng
        model.use_fused_mlp, model.remat = fused, remat
        fm.reset_launches()
        record = []
        with sample_argmax(record):
            _, losses = train_steps(trainer, batch, 1, u=u)
        out = (losses[0], {n: None if p.grad is None
                           else p.grad.detach().clone()
                           for n, p in model.named_parameters()},
               dict(fm.variant_launches),
               torch.cat(record)[:len(real)].cpu().numpy())
        if not timed:
            return out
        torch.cuda.reset_peak_memory_stats()
        times, _ = train_steps(trainer, batch, timed, u=u)
        return out, (statistics.median(times),
                     torch.cuda.max_memory_allocated() / 2**30)

    loss_tol, grad_tol = REMAT_TOL[dtype_name]
    good, res = True, {"chunks": n_chunks, "real_cells": int(real.sum())}
    for fused, label in (("auto", "kernel"), ("false", "plain")):
        (ln, gn, kn, an), (ms_n, peak_n) = step(fused, False, MS_TIMED)
        (lr, gr, kr, ar), (ms_r, peak_r) = step(fused, True, MS_TIMED)
        if fused == "auto":
            # the remat steps' Adam updates: the cache keyed on the
            # parameters' versions holds the new values
            cdt = getattr(torch, dtype_name)
            fresh = all(
                torch.equal(getattr(fm.stacked_params(model.mlp_coarse, cdt),
                                    k),
                            getattr(fm.stack_params(model.mlp_coarse, cdt),
                                    k))
                for k in fm.WEIGHT_NAMES)
            print(f"  kernel weights after the remat steps match the "
                  f"parameters: {'ok' if fresh else 'FAILED: stale'}",
                  flush=True)
            good &= fresh
        loss_err = max(abs(lr[k] - ln[k]) / max(abs(ln[k]), 1e-30)
                       for k in ln)
        moved = (ar != an) & real
        n_moved = int(moved.sum())
        if n_moved:
            trainer._assemble = ignoring(trainer._assemble, moved)
            _, gn, _, _ = step(fused, False)
            _, gr, _, _ = step(fused, True)
            del trainer._assemble
        worst, worst_name, missing = grad_diff(gr, gn)
        var = fm.variant("pre_combine_pe", getattr(torch, dtype_name))
        if fused == "auto":
            counts = {m: (launched(kn, m, var), launched(kr, m, var))
                      for m in ("pre_combine_pe", "post_combine")}
            launch_ok = all(n > 0 and r == 2 * n for n, r in counts.values())
            launches["yolo_3scale_" + dtype_name] = kn
            launches["yolo_3scale_remat_" + dtype_name] = kr
        else:
            counts = {"all": (sum(kn.values()), sum(kr.values()))}
            launch_ok = counts["all"] == (0, 0)
        agree = (all(math.isfinite(v) for v in lr.values())
                 and loss_err <= loss_tol and worst <= grad_tol
                 and not missing and n_moved <= MAX_MOVED * int(real.sum()))
        good &= agree and launch_ok
        res[label] = {"no_remat": {"ms": ms_n, "peak_gib": peak_n,
                                   "launches": kn},
                      "remat": {"ms": ms_r, "peak_gib": peak_r,
                                "launches": kr},
                      "loss_err": loss_err, "grad_err": worst,
                      "argmax_moved": n_moved}
        print(f"3-scale YOLO {dtype_name} {label} route, {n_chunks} chunks "
              f"of {chunk} rays: no remat {ms_n:.3f} ms/step, peak "
              f"{peak_n:.2f} GiB, launches {kn}; remat {ms_r:.3f} ms/step, "
              f"peak {peak_r:.2f} GiB, launches {kr} (no remat, remat: "
              f"{counts}; remat must launch each kernel twice as often: "
              f"{'ok' if launch_ok else 'FAILED'})", flush=True)
        print(f"  remat vs no remat: losses {lr} | {ln}; max relative loss "
              f"diff {loss_err:.3e} (tol {loss_tol}); argmax moved in "
              f"{n_moved} of {int(real.sum())} real cells; worst gradient "
              f"relative L2 {worst:.3e} at {worst_name} (tol {grad_tol}); "
              f"gradient on one side only: {missing} "
              f"{'ok' if agree else 'FAILED'}", flush=True)
    results["yolo_3scale_" + dtype_name] = res
    return good


def remat_policies(device, tmp, launches, results) -> bool:
    """Phase 10 (b): at phase 9's train_nerf point (8,192 rays, NS=1), in
    f32 on the plain route, one step without remat and one under each
    remat policy and remat_gather, from the same weights, pixels and draws:
    losses and gradients against no remat, then MS_TIMED more steps of
    each (ms/step, peak memory); then the same on the kernel route with
    and without remat, whose full_pe launches are 2 passes x the chunks
    of the remat budget x 2 (the replay); then a bf16 kernel-route step
    with remat against one without, beside witnesses (``force_chunking``)
    that take the replay and the chunking apart."""
    import torch

    from pixelnerf_yolo_torch.config.flagship import TRAIN_NERF_RAYS
    from pixelnerf_yolo_torch.ops import field_mlp as fm

    def one(fused, puts, dtype_name="float32", remat_chunks=None,
            timed=True):
        trainer, model, batch, draws = nerf_trainer(
            device, dtype_name, tmp, 1, TRAIN_NERF_RAYS, puts)
        model.use_fused_mlp = fused
        if remat_chunks is not None:
            force_chunking(trainer.renderer, remat_chunks)
        fm.reset_launches()
        _, losses = train_steps(trainer, batch, 1, draws=draws)
        grads = {n: None if p.grad is None else p.grad.detach().clone()
                 for n, p in model.named_parameters()}
        counts = dict(fm.variant_launches)
        times, peak = [math.nan], math.nan
        if timed:
            torch.cuda.reset_peak_memory_stats()
            times, _ = train_steps(trainer, batch, MS_TIMED, draws=draws)
            peak = torch.cuda.max_memory_allocated() / 2**30
        out = (losses[0], grads, counts, statistics.median(times), peak,
               trainer.renderer)
        del trainer, model
        torch.cuda.empty_cache()
        return out

    def against(got, base):
        loss_err = max(abs(got[0][k] - base[0][k])
                       / max(abs(base[0][k]), 1e-30) for k in base[0])
        return (loss_err,) + grad_diff(got[1], base[1])

    good, res = True, {}
    loss_tol, grad_tol = REMAT_TOL["float32"]
    base = one("false", {})
    res["none"] = {"ms": base[3], "peak_gib": base[4]}
    print(f"remat at the train_nerf point, f32 plain route, "
          f"{TRAIN_NERF_RAYS} rays: no remat {base[3]:.3f} ms/step (median "
          f"of {MS_TIMED} after one), peak {base[4]:.2f} GiB", flush=True)
    for policy, gather in POLICIES:
        got = one("false", {"model.remat": True,
                            "model.remat_policy": policy,
                            "model.remat_gather": gather})
        loss_err, worst, worst_name, missing = against(got, base)
        agree = (loss_err <= loss_tol and worst <= grad_tol and not missing
                 and sum(got[2].values()) == 0)
        good &= agree
        name = "remat_gather" if gather else policy
        res[name] = {"ms": got[3], "peak_gib": got[4], "loss_err": loss_err,
                     "grad_err": worst}
        print(f"  {name:12s}: {got[3]:.3f} ms/step, peak {got[4]:.2f} GiB; "
              f"against no remat: loss {loss_err:.3e} (tol {loss_tol}), "
              f"worst gradient relative L2 {worst:.3e} at {worst_name} (tol "
              f"{grad_tol}) {'ok' if agree else 'FAILED'}", flush=True)

    plain = one("auto", {})
    got = one("auto", {"model.remat": True})
    cb = got[5]._chunk_rays(TRAIN_NERF_RAYS, 1, 512, grad_remat=True)
    n_chunks = -(-TRAIN_NERF_RAYS // cb)
    var = fm.variant("full_pe", torch.float32)
    want = 2 * n_chunks * 2
    n = launched(got[2], "full_pe", var)
    loss_err, worst, worst_name, missing = against(got, plain)
    agree = (n == want and launched(plain[2], "full_pe", var) == 2
             and loss_err <= loss_tol and worst <= grad_tol and not missing)
    good &= agree
    launches["train_nerf_remat_f32"] = got[2]
    res["kernel"] = {"ms": got[3], "peak_gib": got[4],
                     "no_remat_ms": plain[3], "no_remat_peak_gib": plain[4],
                     "launches": got[2], "loss_err": loss_err,
                     "grad_err": worst}
    print(f"  f32 kernel route with remat: {got[3]:.3f} ms/step, peak "
          f"{got[4]:.2f} GiB (without: {plain[3]:.3f} ms/step, "
          f"{plain[4]:.2f} GiB); full_pe launches {n}, expected {want} (2 "
          f"passes x {n_chunks} chunks of {cb} rays x 2, the replay); "
          f"against no remat: loss {loss_err:.3e}, worst gradient relative "
          f"L2 {worst:.3e} at {worst_name} {'ok' if agree else 'FAILED'}",
          flush=True)
    # bf16 on the kernel route: the step with remat (the remat budget's
    # chunks) against the step without, held to REMAT_TOL, beside the same
    # step without remat taken again (the gather's f32 atomics alone) and
    # each change alone: remat at the no-remat chunking, no remat at the
    # remat chunking
    base = one("auto", {}, "bfloat16", timed=False)
    res["bf16_witness"] = {}
    loss_tol, grad_tol = REMAT_TOL["bfloat16"]
    var = fm.variant("full_pe", torch.bfloat16)
    print("  bf16 kernel route, against a step without remat (worst "
          "gradient relative L2):", flush=True)
    for name, puts, chunks in (
            ("remat", {"model.remat": True}, None),
            ("no remat again", {}, None),
            ("remat, no-remat chunks", {"model.remat": True}, False),
            ("no remat, remat chunks", {}, True)):
        got = one("auto", puts, "bfloat16", chunks, timed=False)
        loss_err, worst, worst_name, missing = against(got, base)
        res["bf16_witness"][name] = {"loss_err": loss_err, "grad_err": worst,
                                     "at": worst_name, "launches": got[2]}
        verdict = "(printed)"
        if name == "remat":
            agree = (loss_err <= loss_tol and worst <= grad_tol
                     and not missing and launched(got[2], "full_pe", var)
                     == want)
            good &= agree
            launches["train_nerf_remat_bf16"] = got[2]
            verdict = (f"(tol {loss_tol} / {grad_tol}, full_pe {want} "
                       f"launches) {'ok' if agree else 'FAILED'}")
        print(f"    {name:24s}: loss {loss_err:.3e}, gradient {worst:.3e} "
              f"at {worst_name}; launches {got[2]} {verdict}", flush=True)
    results["remat_train_nerf"] = res
    return good


def force_chunking(renderer, remat_budget: bool):
    """Make the NeRF renderer chunk its rays by the remat budget
    (remat_budget) or by the budget without remat, whether or not the
    model is under remat."""
    chunk_rays = renderer._chunk_rays

    def forced(*args, **kwargs):
        kwargs["grad_remat"] = remat_budget
        return chunk_rays(*args, **kwargs)

    # the renderer is a frozen dataclass: set the instance's attribute
    object.__setattr__(renderer, "_chunk_rays", forced)


def eval_threshold(raw, n_keep: int = 150) -> float:
    """A confidence that about n_keep of the raw predicted boxes of raw
    (the protocol's per-scale decode lists) exceed, in the widest gap
    between neighbouring confidences around the n_keep-th: random weights
    put most of the 27,216 boxes over the recipe's 0.45, and the host list
    NMS is quadratic in them."""
    import numpy as np

    conf = np.sort(np.concatenate([
        np.asarray([b[1] for sc in per_scale for b in sc], np.float64)
        for _, per_scale in raw]))[::-1]
    lo, hi = n_keep // 2, min(2 * n_keep, len(conf) - 1)
    gaps = conf[lo:hi] - conf[lo + 1:hi + 1]
    i = lo + int(np.argmax(gaps))
    return float((conf[i] + conf[i + 1]) / 2)


def top_boxes(per_scale, threshold, n=EVAL_GT_ADDED, max_iou=0.1):
    """The n most confident boxes of one view's per-scale decode lists
    above threshold, of a size a target can have (0.01 to 0.5 of the
    view), none overlapping a more confident one by IoU > max_iou, as
    [x, y, w, h, class] target rows."""
    import numpy as np

    from pixelnerf_yolo_torch.detect.boxes import iou

    rows = sorted((b for sc in per_scale for b in sc
                   if b[1] > threshold and 0.01 < b[4] < 0.5
                   and 0.01 < b[5] < 0.5), key=lambda b: -b[1])
    picked = []
    for b in rows:
        if all(float(np.asarray(iou(np.asarray(b[2:6]),
                                    np.asarray(q[2:6]))).reshape(-1)[0])
               <= max_iou for q in picked):
            picked.append(b)
        if len(picked) == n:
            break
    return [[*b[2:6], b[0]] for b in picked]


@contextlib.contextmanager
def metric_record(trainer, rec: dict):
    """While open, appends to rec["boxes"] each (bbox_gt, bbox_pred) pair
    the trainer's metric protocol yields and to rec["counts"] the (tp,
    fp, fn) the trainer's F1 path counts for each."""
    boxes_of, counts_of = trainer._iter_metric_boxes, trainer._tp_fp_fn_one
    rec.update(boxes=[], counts=[])

    def boxes(*args, **kwargs):
        for item in boxes_of(*args, **kwargs):
            rec["boxes"].append(item)
            yield item

    def counts(*args, **kwargs):
        out = counts_of(*args, **kwargs)
        rec["counts"].append(tuple(int(x) for x in out))
        return out

    trainer._iter_metric_boxes, trainer._tp_fp_fn_one = boxes, counts
    try:
        yield rec
    finally:
        del trainer._iter_metric_boxes, trainer._tp_fp_fn_one


def kept_boxes_diff(trainer, got, want):
    """(same, worst, n_kept, raw_same) over the views of two recordings of
    the metric protocol (``metric_record``): same when each view's ground
    truth is identical and the boxes the device NMS keeps of its predicted
    boxes at the trainer's thresholds pair up one to one, each with a box
    of the same class; worst the largest difference of a pair's score, x,
    y, w or h relative to max(1, |value|) (pairs matched greedily by that
    difference, so near-equal scores may swap order); n_kept the kept
    boxes of got; raw_same whether the lists before NMS have one length
    (cross-scale suppression's greedy order over the thousands of
    low-confidence boxes may differ, which the NMS's cut drops)."""
    import numpy as np
    import torch

    from pixelnerf_yolo_torch.detect.nms import nms_padded

    def kept(pred):
        rows = np.asarray(pred, np.float32).reshape(-1, 6)
        k, v = nms_padded(torch.from_numpy(rows).to(trainer.device),
                          trainer.nms_iou_threshold, trainer.nms_threshold,
                          max(len(rows), 1))
        return k[v].double().cpu().numpy()

    same = len(got) == len(want)
    worst, n_kept, raw_same = 0.0, 0, True
    for (gt_g, pred_g), (gt_w, pred_w) in zip(got, want):
        same &= gt_g == gt_w
        raw_same &= len(pred_g) == len(pred_w)
        g, w = kept(pred_g), kept(pred_w)
        n_kept += len(g)
        if len(g) != len(w):
            same = False
            continue
        free = np.ones(len(w), bool)
        for row in g:
            d = np.max(np.abs(w[:, 1:] - row[1:])
                       / np.maximum(1.0, np.abs(w[:, 1:])), axis=1)
            d[~free | (w[:, 0] != row[0])] = np.inf
            j = int(np.argmin(d))
            if not np.isfinite(d[j]):
                same = False
                break
            free[j] = False
            worst = max(worst, float(d[j]))
    return same, worst, n_kept, raw_same


def multiscale_eval(device, dtype_name, tmp, launches, results) -> bool:
    """Phase 10 (c) in one dtype: the recipe's metric protocol over phase
    5's scene on the kernel route and the plain route, from the same
    renders' draws.  A pass on the plain route first sets yolo.nms_threshold
    to a confidence about 150 of the random weights' boxes exceed
    (``eval_threshold``) and adds each destination's EVAL_GT_ADDED most
    confident boxes to its ground truth (``top_boxes``), so that TP,
    P/R/F1 and mAP carry signal.  Then on each route metric_and_map_step
    as eval_yolo runs it by default (the device NMS), its TP/FP/FN of each
    view and the box lists it consumed recorded (``metric_record``); in
    f32 also calibrate_scales at the single combination [nms_threshold]
    and, on the kernel route, metric_step with host matching
    (``--host_nms``), which must equal it.  f32: the routes' TP/FP/FN of
    every view and of calibrate_scales identical, the boxes the device NMS
    keeps paired within EVAL_BOX_TOL (``kept_boxes_diff``), P/R/F1
    identical, mAP within 1e-6 and TP above 0; bf16 printed."""
    import torch

    from pixelnerf_yolo_torch.config.flagship import train_yolo_3scale_conf
    from pixelnerf_yolo_torch.data import DataLoader
    from pixelnerf_yolo_torch.ops import field_mlp as fm

    conf = train_yolo_3scale_conf(dtype_name)
    trainer, model, _, batch = multiscale_trainer(
        device, conf, os.path.join(tmp, "mse_" + dtype_name), MS_EVAL_SIZE)
    view_rng = trainer._rng.bit_generator.state
    f32 = dtype_name == "float32"

    def fresh():
        trainer._gen.manual_seed(2)
        trainer._rng.bit_generator.state = view_rng

    model.use_fused_mlp = "false"
    fresh()
    raw = list(trainer._iter_metric_boxes([batch], "per_scale"))
    trainer.nms_threshold = eval_threshold(raw)
    dests = [int(d) for views in trainer.metric_views for d in views]
    extra = {}
    for dest, (_, per_scale) in zip(dests, raw):
        extra.setdefault(dest, top_boxes(per_scale, trainer.nms_threshold))
    loader = [next(iter(DataLoader(
        train_dataset(conf, MS_EVAL_SIZE, extra), batch_size=1)))]
    print(f"3-scale evaluation {dtype_name}: nms_threshold "
          f"{trainer.nms_threshold:.6f}; ground truth added from the plain "
          f"route's most confident boxes: "
          f"{ {v: len(b) for v, b in extra.items()} }", flush=True)
    good, res = True, {"nms_threshold": trainer.nms_threshold,
                       "gt_added": {v: len(b) for v, b in extra.items()}}
    for fused, label in (("auto", "kernel"), ("false", "plain")):
        model.use_fused_mlp = fused
        fresh()
        rec = {}
        fm.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with metric_record(trainer, rec):
            (p, r, f1), (map50, per_class) = trainer.metric_and_map_step(
                loader)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = dict(fm.variant_launches)
        total = tuple(map(sum, zip(*rec["counts"])))
        res[label] = {"prf1": (p, r, f1), "map50": map50,
                      "per_class": per_class, "seconds": sec,
                      "launches": counts, "tp_fp_fn": total,
                      "per_view": rec["counts"], "boxes": rec["boxes"]}
        print(f"  {label} route, metric_and_map_step (device NMS): TP/FP/FN "
              f"{'/'.join(map(str, total))} (per view {rec['counts']}), "
              f"P/R/F1 {p:.6f}/{r:.6f}/{f1:.6f}, mAP@0.5 {map50:.8f} "
              f"{per_class} in {sec:.3f} s (3 views x 3 scales, 3,024 rays "
              f"each); launches {counts}", flush=True)
        if fused == "auto":
            var = fm.variant("pre_combine_pe", getattr(torch, dtype_name))
            good &= (launched(counts, "pre_combine_pe", var) > 0
                     and launched(counts, "post_combine", var) > 0)
            launches["yolo_3scale_eval_" + dtype_name] = counts
        else:
            good &= sum(counts.values()) == 0
        if not f32:
            continue
        fresh()
        cal = trainer.calibrate_scales(loader, [trainer.nms_threshold])[0][0]
        res[label]["calibrate"] = (cal["tp"], cal["fp"], cal["fn"])
        txt = (f"  {label} route, calibrate_scales at "
               f"[{trainer.nms_threshold:.6f}] (host matching): TP/FP/FN "
               f"{cal['tp']}/{cal['fp']}/{cal['fn']}, P/R/F1 "
               f"{cal['precision']:.6f}/{cal['recall']:.6f}/"
               f"{cal['f1']:.6f}, mAP@0.5 {cal['map50']:.8f}")
        if fused == "auto":
            fresh()
            host_rec = {}
            trainer.use_host_nms = True
            try:
                with metric_record(trainer, host_rec):
                    host = trainer.metric_step(loader)
            finally:
                trainer.use_host_nms = False
            host_total = tuple(map(sum, zip(*host_rec["counts"])))
            same = (host == (cal["precision"], cal["recall"], cal["f1"])
                    and host_total == res[label]["calibrate"])
            txt += (f"; metric_step with host matching: TP/FP/FN "
                    f"{'/'.join(map(str, host_total))}, P/R/F1 "
                    f"{'/'.join(f'{x:.6f}' for x in host)}: equal "
                    f"{'ok' if same else 'FAILED'} (the host list NMS "
                    f"keeps some of the ground truth's per-scale "
                    f"duplicates that the device NMS drops, so its FN may "
                    f"be larger)")
            good &= same
        print(txt, flush=True)
    k, p = res["kernel"], res["plain"]
    map_err = max([abs(k["map50"] - p["map50"])]
                  + [abs(k["per_class"][c] - p["per_class"].get(c, math.inf))
                     for c in k["per_class"]])
    boxes_same, box_err, n_kept, raw_same = kept_boxes_diff(
        trainer, k.pop("boxes"), p.pop("boxes"))
    same = (k["prf1"] == p["prf1"] and k["per_view"] == p["per_view"]
            and k.get("calibrate") == p.get("calibrate"))
    agree = (same and boxes_same and box_err <= EVAL_BOX_TOL
             and map_err <= 1e-6 and k["tp_fp_fn"][0] > 0)
    res.update(box_err=box_err, map_err=map_err, n_kept=n_kept,
               raw_same=raw_same)
    print(f"  kernel vs plain route: TP/FP/FN of every view, P/R/F1"
          f"{' and calibrate_scales' if f32 else ''} identical: {same}; the "
          f"{n_kept} boxes the device NMS keeps pair up by class: "
          f"{boxes_same}, largest difference {box_err:.3e}; lists before "
          f"NMS of one length: {raw_same}; mAP differs by {map_err:.3e}; "
          f"TP {k['tp_fp_fn'][0]} "
          + ("(f32: identical, boxes within "
             f"{EVAL_BOX_TOL}, mAP within 1e-6, TP > 0) "
             + ("ok" if agree else "FAILED") if f32 else "(bf16: printed)"),
          flush=True)
    if f32:
        good &= agree
    results["yolo_3scale_eval_" + dtype_name] = res
    return good


# -- phase 11: NeRF evaluation ----------------------------------------------


def nerf_eval_path(device):
    """Phase 11: eval.evaluate (PSNR and SSIM of every target view) and
    gen_video's render loop (an orbit) on the flagship NeRF model over
    phase 9's scene, at NS=1 (full_pe) and NS=2 (pre_combine_pe +
    post_combine), in bf16 and f32, on the kernel route and the plain
    route with the same draws.  f32: PSNR within 1e-4 dB, SSIM within
    1e-6, frames within RENDER_TOL; bf16 printed.  Returns (ok, launches
    by path, results)."""
    import dataclasses as dc

    import numpy as np
    import torch

    from pixelnerf_yolo_torch.eval.eval import evaluate
    from pixelnerf_yolo_torch.eval.gen_video import render_video, trajectory
    from pixelnerf_yolo_torch.ops import field_mlp as fm

    dset = nerf_train_dataset()
    models = build_models(device)
    poses = trajectory(VIDEO_FRAMES, -10.0, 0.5 * (NERF_NEAR + NERF_FAR))
    ok, launches, results = True, {}, {}
    for dtype_name in ("bfloat16", "float32"):
        model, renderer = models[dtype_name]
        renderer = dc.replace(renderer, eval_batch_size=EVAL_RAYS)
        for ns, source in ((1, [0]), (2, [0, 3])):
            out = {}
            for fused in ("auto", "false"):
                model.use_fused_mlp = fused
                fm.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = evaluate(model, renderer, dset, source=np.array(source),
                             ray_batch_size=EVAL_RAYS)
                frames = render_video(model, renderer, dset[0],
                                      np.array(source), poses, NERF_NEAR,
                                      NERF_FAR, ray_batch_size=EVAL_RAYS)
                torch.cuda.synchronize()
                out[fused] = (m, frames, dict(fm.variant_launches),
                              time.perf_counter() - t0)
            (mk, fk, lk, sk), (mp, fp, lp, sp) = out["auto"], out["false"]
            if ns == 1:
                path_ok = (launched(lk, "full_pe", fm.variant(
                    "full_pe", getattr(torch, dtype_name))) > 0
                    and launched(lk, "pre_combine_pe") == 0)
            else:
                var = fm.variant("pre_combine_pe", getattr(torch, dtype_name))
                path_ok = (launched(lk, "pre_combine_pe", var) > 0
                           and launched(lk, "post_combine", var) > 0
                           and launched(lk, "full_pe") == 0)
            path_ok &= sum(lp.values()) == 0
            d_psnr = abs(mk["psnr"] - mp["psnr"])
            d_ssim = abs(mk["ssim"] - mp["ssim"])
            d_frames = float(np.abs(fk - fp).max())
            agree = (d_psnr <= EVAL_TOL["psnr"] and d_ssim <= EVAL_TOL["ssim"]
                     and d_frames <= RENDER_TOL["float32"])
            good = path_ok and np.isfinite(mk["psnr"]) and (
                agree or dtype_name == "bfloat16")
            ok &= good
            key = f"nerf_eval_ns{ns}_{dtype_name}"
            launches[key] = lk
            results[key] = {"psnr": (mk["psnr"], mp["psnr"]),
                            "ssim": (mk["ssim"], mp["ssim"]),
                            "frames_max_diff": d_frames,
                            "seconds": (sk, sp), "launches": lk}
            side = NERF_TRAIN_SIZE
            print(f"NeRF evaluation NS={ns} {dtype_name}: {len(mk['objects'])}"
                  f" object, {NERF_TRAIN_VIEWS - ns} target views + "
                  f"{VIDEO_FRAMES} orbit frames of {side}x{side}; kernel "
                  f"route PSNR {mk['psnr']:.6f} "
                  f"SSIM {mk['ssim']:.8f} in {sk:.3f} s, plain PSNR "
                  f"{mp['psnr']:.6f} SSIM {mp['ssim']:.8f} in {sp:.3f} s; "
                  f"|dPSNR| {d_psnr:.3e} |dSSIM| {d_ssim:.3e}, frames "
                  f"max|diff| {d_frames:.3e}; launches {lk} "
                  + ("ok" if good else "FAILED")
                  + (" (bf16: differences printed)"
                     if dtype_name == "bfloat16" else ""), flush=True)
    del models
    torch.cuda.empty_cache()
    return ok, launches, results


# -- phase 12: serving modes ------------------------------------------------

# renders timed a mode: the median and the spread (max - min) of SERVE_REPS
# synchronized renders after the compared one (the modes that take
# seconds, f32 and the int8 MLP: 1)
SERVE_REPS = 3
# early termination: the fraction of each chunk's rays given the fine pass
GATE_F = 0.25
# one-hot gather, card vs CPU: points sampled over the table and its border
GATHER_POINTS = 4096
# JAX's own bounds for the int8 modes against the exact render: the int8
# latent table's rgb (tests/test_model_render.py TestLatentInt8, here on
# every output, relative to max(1, max|exact|)) and the int8 MLP's rgb
# (tests/test_quant.py)
LATENT_INT8_TOL, MLP_INT8_RGB_TOL = 0.05, 0.12
# SPADE, the card against the CPU: f32, 1e-4 x max(1, max|cpu|).  At
# random init scale_z's scales have a std of ~25 (18-std latents through a
# kaiming 512-wide layer) and widen the field ~1,000x (max 2,311 against
# 2.35 without SPADE, measured on an H100), so the render carries f32's
# rounding x 1,000 (7.0e-4 in rgb; the field itself 4.8e-6 relative, as
# without SPADE): the field is compared at those weights, the render with
# scale_z scaled by SPADE_SCALE (scales of std ~1), as build_models puts
# lin_out in its working range
SPADE_TOL, SPADE_RAYS, SPADE_SCALE = 1e-4, 1024, 1 / 25
# the int8 product held to the CPU's
W8A8_SHAPE = (4096, 512, 512)
SERVE_RAYS = 16384  # YOLO and the exported renders; NeRF gating: RENDERS[0]


def bf16_ulps(a, b):
    """Largest |a - b| in bf16 units in the last place of max(|a|, |b|)."""
    import torch

    a, b = a.double(), b.double()
    m = torch.maximum(a.abs(), b.abs())
    ulp = torch.exp2(torch.floor(torch.log2(torch.where(m > 0, m,
                                                       torch.ones_like(m))))
                     - 7)
    return ((a - b).abs() / ulp).max().item()


def timed(fn, reps: int):
    """(first result, [seconds of reps more calls], peak GiB): synchronized
    host-clock times of fn(), the peak memory over all of them."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    secs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return out, secs, torch.cuda.max_memory_allocated() / 2**30


def serve_line(label, secs, peak, launches, extra=""):
    med = statistics.median(secs)
    print(f"  {label}: {med:.4f} s median of {len(secs)} (spread "
          f"{max(secs) - min(secs):.4f} s), peak {peak:.2f} GiB, launches "
          f"{launches}{extra}", flush=True)
    return {"median_s": med, "spread_s": max(secs) - min(secs),
            "secs": secs, "peak_gib": peak, "launches": launches}


def yolo_serve_render(model, renderer, device, fused, n_rays=SERVE_RAYS):
    """(cond, rays, a function rendering them with fixed draws)."""
    import torch

    from pixelnerf_yolo_torch.utils.camera import gen_rays_yolo

    model.use_fused_mlp = fused
    images, poses, focal, c, target = yolo_scene(3, YOLO_SIZE)
    with torch.no_grad():
        cond = model.encode(images, poses, focal, c=c)
    rays = gen_rays_yolo(torch.from_numpy(target).to(device), YOLO_SIZE,
                         YOLO_SIZE, focal[0], c[0], YOLO_NEAR,
                         YOLO_FAR).reshape(1, -1, 8)[:, :n_rays]
    u = torch.rand((n_rays, renderer.n_coarse), device=device,
                   generator=torch.Generator(device=device).manual_seed(3))
    return cond, rays, lambda: renderer(model, cond, rays, u=u)


def serve_yolo(models, device, results):
    """Phase 12 (a): the bf16 YOLO flagship on the kernel route, the plain
    route with the pre-projected table and the plain route without it;
    the one-hot gather on the card against the CPU."""
    import torch

    from pixelnerf_yolo_torch.ops import field_mlp as fm
    from pixelnerf_yolo_torch.ops.grid_sample import grid_sample_nhwc

    model, renderer = models["bfloat16"]
    outs, ok, launches = {}, True, {}
    for label, fused, pre in (("kernel", "auto", True),
                              ("plain_preprojected", "false", True),
                              ("plain_raw", "false", False)):
        model.latent_preproject = pre
        fm.reset_launches()
        cond, rays, fn = yolo_serve_render(model, renderer, device, fused)
        out, secs, peak = timed(fn, SERVE_REPS)
        lk = dict(fm.variant_launches)
        n = SERVE_RAYS
        cb = renderer.chunk_rays_for(n, 3, cond.latent_flat.shape[-1])
        chunks = -(-n // cb)
        results[f"yolo_{label}"] = serve_line(
            f"YOLO NS=3 bf16 {n} rays, {label}", secs, peak, lk,
            f"; table {tuple(cond.latent_flat.shape)}, projected "
            f"{cond.latent_projected}, {chunks} chunks of "
            f"{-(-n // chunks)} rays")
        results[f"yolo_{label}"]["chunks"] = chunks
        want_kernels = fused == "auto"
        good = (cond.latent_projected == (pre and not want_kernels)
                and (launched(lk, "pre_combine_pe", "tensor_core") > 0
                     and launched(lk, "post_combine", "tensor_core") > 0)
                == want_kernels and (want_kernels or sum(lk.values()) == 0))
        if not good:
            print(f"FAILED: the {label} route's table or launches")
        ok &= good
        launches[f"serve_yolo_{label}"] = lk
        outs[label] = out
    model.latent_preproject = True
    for a, b in (("kernel", "plain_preprojected"), ("kernel", "plain_raw"),
                 ("plain_preprojected", "plain_raw")):
        print(f"  {a} vs {b}:")
        ok &= compare_yolo(outs[a], outs[b], YOLO_TOL["bfloat16"])
    # the gather at the one-hot rounding points: the card against the CPU
    table = cond.latent_flat  # the raw bf16 table (plain_raw's)
    Hl, Wl = cond.latent_hw
    g = torch.Generator().manual_seed(4)
    grid = (torch.rand((table.shape[0], GATHER_POINTS, 2), generator=g)
            * 2.4 - 1.2)
    got = grid_sample_nhwc(table, grid.to(device), Hl, Wl,
                           padding_mode="border", align_corners=True,
                           interp_matmul=True).float().cpu()
    ref = grid_sample_nhwc(table.cpu(), grid, Hl, Wl, padding_mode="border",
                           align_corners=True, interp_matmul=True).float()
    ulps = bf16_ulps(got, ref)
    good = ulps <= 1 and Hl * Wl <= 1024 and bool(torch.isfinite(got).all())
    print(f"  one-hot gather, {Hl * Wl}-row table x {table.shape[-1]}, "
          f"{GATHER_POINTS} points a view: card vs CPU {ulps:.1f} bf16 ulp "
          f"(limit 1) {'ok' if good else 'FAILED'}", flush=True)
    results["yolo_gather_ulps"] = ulps
    del outs, cond
    torch.cuda.empty_cache()
    return ok & good, launches


def serve_gate(models, device, results):
    """Phase 12 (b): early_terminate on the NeRF flagship, NS=1, kernel
    route, bf16 and f32: f = 1 bitwise the ungated render; f = GATE_F the
    kept rays' fine outputs within RENDER_TOL of the ungated render, the
    others' fine outputs their coarse ones exactly, full_pe's fine
    launches on the gated rows."""
    import dataclasses as dc

    import torch

    from pixelnerf_yolo_torch.ops import field_mlp as fm

    ok, launches = True, {}
    n = RENDERS[0][2]
    for dtype_name in ("bfloat16", "float32"):
        model, renderer = models[dtype_name]
        model.use_fused_mlp = "auto"
        images, poses, focal, rays = flagship_scene(1, n, device)
        with torch.no_grad():
            cond = model.encode(images, poses, focal)
        cb = renderer._chunk_rays(n, 1)  # rays a chunk; fine-pass rays:
        cc = dc.replace(renderer, early_terminate=GATE_F)._gated_capacity(cb)
        nc = -(-n // cb)
        draws = renderer.draw(nc * cb, torch.Generator(device=device)
                              .manual_seed(3), device)
        outs = {}
        for f in (0.0, 1.0, GATE_F):
            # f = 1 is compared, not timed
            reps = (0 if f == 1.0 else SERVE_REPS if dtype_name == "bfloat16"
                    else 1)
            r = dc.replace(renderer, early_terminate=f)
            rows = []
            full_pe = fm.full_pe

            def counting(base, latent, w, code, _f=full_pe):
                rows.append(latent.shape[0])
                return _f(base, latent, w, code)

            fm.reset_launches()
            fm.full_pe = counting
            try:
                out, secs, peak = timed(
                    lambda: r(model, cond, rays, draws=draws,
                              want_weights=True), reps)
            finally:
                fm.full_pe = full_pe
            lk = dict(fm.variant_launches)
            launches[f"serve_gate_{f}_{dtype_name}"] = lk
            outs[f] = out
            per_render = rows[:len(rows) // (reps + 1)]
            if reps:
                results[f"gate_{f}_{dtype_name}"] = serve_line(
                    f"NeRF NS=1 {dtype_name} {n} rays, early_terminate {f}",
                    secs, peak, lk, f"; full_pe rows a render {per_render}")
            if f == GATE_F:
                want = [cb * renderer.n_coarse,
                        cc * (renderer.n_coarse + renderer.n_fine)] * nc
                good = per_render == want
                print(f"  full_pe rows: coarse {cb} x {renderer.n_coarse}, "
                      f"fine {cc} x {renderer.n_coarse + renderer.n_fine} "
                      f"a chunk ({nc} chunks): "
                      f"{'ok' if good else 'FAILED, want ' + str(want)}")
                ok &= good
        base, one, gated = outs[0.0], outs[1.0], outs[GATE_F]
        same = all(torch.equal(one[p][k], base[p][k])
                   for p in ("coarse", "fine")
                   for k in ("rgb", "depth", "weights"))
        # the kept rays: each chunk's top cc by coarse weight sum
        wsum = base["coarse"]["weights"][0].sum(-1)
        pad = nc * cb - n
        wsum = torch.cat([wsum, wsum[:1].expand(pad)]).reshape(nc, cb)
        idx = torch.sort(wsum, dim=1, descending=True,
                         stable=True).indices[:, :cc]
        kept = torch.zeros((nc, cb), dtype=torch.bool, device=device)
        kept[torch.arange(nc, device=device)[:, None], idx] = True
        kept = kept.reshape(-1)[:n]
        tol = RENDER_TOL[dtype_name]
        if nc * cb != n:  # the padded rays' weights are not in the output
            print(f"FAILED: {n} rays do not split into chunks of {cb}")
            ok = False
        d_kept = max((gated["fine"][k][0][kept] - base["fine"][k][0][kept])
                     .abs().max().item() for k in ("rgb", "depth"))
        skipped_exact = all(torch.equal(gated["fine"][k][0][~kept],
                                        gated["coarse"][k][0][~kept])
                            for k in ("rgb", "depth"))
        good = same and d_kept <= tol and skipped_exact and bool(
            torch.isfinite(gated["fine"]["rgb"]).all())
        print(f"  {dtype_name}: f=1 bitwise ungated {same}; f={GATE_F}: "
              f"{int(kept.sum())} of {n} rays kept, their fine max|diff| "
              f"{d_kept:.3e} (tol {tol}), the rest's fine == coarse "
              f"{skipped_exact} {'ok' if good else 'FAILED'}", flush=True)
        ok &= good
        del outs, base, one, gated, cond
        torch.cuda.empty_cache()
    return ok, launches


def serve_int8(nerf, yolo, device, results):
    """Phase 12 (c), (d): model.latent_int8 (YOLO bf16 and f32, NeRF NS=1
    bf16: kernel route against plain route, and against the render
    without int8) and model.mlp_int8 (NeRF NS=1 bf16, plain route: no
    kernel launch; rgb against the bf16 render; the int8 product on the
    card against the CPU's)."""
    import torch

    from pixelnerf_yolo_torch.nn import quant
    from pixelnerf_yolo_torch.ops import field_mlp as fm

    ok, launches = True, {}

    def nerf_fn(model, renderer, fused):
        model.use_fused_mlp = fused
        n = RENDERS[0][2]
        images, poses, focal, rays = flagship_scene(1, n, device)
        with torch.no_grad():
            cond = model.encode(images, poses, focal)
        draws = renderer.draw(n, torch.Generator(device=device)
                              .manual_seed(3), device)
        return cond, lambda: renderer(model, cond, rays, draws=draws)

    def yolo_fn(model, renderer, fused):
        cond, _, fn = yolo_serve_render(model, renderer, device, fused)
        return cond, fn

    def run(label, model, renderer, make, fused, reps):
        """One render compared, reps more timed (none: untimed)."""
        fm.reset_launches()
        cond, fn = make(model, renderer, fused)
        out, secs, peak = timed(fn, reps)
        lk = dict(fm.variant_launches)
        launches[f"serve_{label}"] = lk
        if reps:
            results[label] = serve_line(label, secs, peak, lk,
                                        f"; table {cond.latent_flat.dtype}")
        return out, cond, lk

    def nerf_diff(a, b, keys=("rgb", "depth")):
        return max((a[p][k].float() - b[p][k].float()).abs().max().item()
                   for p in ("coarse", "fine") for k in keys)

    for mode, dtype_name, models, make in (
            ("yolo", "bfloat16", yolo, yolo_fn),
            ("yolo", "float32", yolo, yolo_fn),
            ("nerf", "bfloat16", nerf, nerf_fn)):
        model, renderer = models[dtype_name]
        reps = 1 if mode == "yolo" and dtype_name == "float32" else SERVE_REPS
        model.latent_int8 = False
        exact, _, _ = run(f"{mode}_exact_{dtype_name}", model, renderer,
                          make, "auto", 0)
        model.latent_int8 = True
        try:
            k8, cond, lk = run(f"{mode}_latent_int8_kernel_{dtype_name}",
                               model, renderer, make, "auto", reps)
            p8, _, lp = run(f"{mode}_latent_int8_plain_{dtype_name}", model,
                            renderer, make, "false", reps)
        finally:
            model.latent_int8 = False
        first = "pre_combine_pe" if mode == "yolo" else "full_pe"
        good = (cond.latent_flat.dtype == torch.int8
                and launched(lk, first) > 0 and sum(lp.values()) == 0)
        tol = YOLO_TOL[dtype_name] if mode == "yolo" else RENDER_TOL[
            dtype_name]
        if mode == "yolo":
            print("  int8 table, kernel vs plain:")
            good &= compare_yolo(k8, p8, tol)
            scale = max(1.0, exact.abs().max().item())
            d_exact = (k8 - exact).abs().max().item()
        else:
            d = nerf_diff(k8, p8)
            print(f"  int8 table, kernel vs plain max|diff| {d:.3e} "
                  f"(tol {tol})")
            good &= d <= tol
            scale = max(1.0, max(exact[p]["rgb"].abs().max().item()
                                 for p in ("coarse", "fine")))
            d_exact = nerf_diff(k8, exact, ("rgb",))
        near = d_exact <= LATENT_INT8_TOL * scale
        print(f"  int8 table vs exact ({mode} {dtype_name}) max|diff| "
              f"{d_exact:.3e} (tol {LATENT_INT8_TOL * scale:.3e}) "
              f"{'ok' if good and near else 'FAILED'}", flush=True)
        results[f"{mode}_latent_int8_{dtype_name}_vs_exact"] = d_exact
        ok &= good and near
        del exact, k8, p8, cond
        torch.cuda.empty_cache()

    # (d) mlp_int8: NeRF NS=1 bf16, plain route
    model, renderer = nerf["bfloat16"]
    plain, _, _ = run("nerf_plain_bfloat16", model, renderer, nerf_fn,
                      "false", SERVE_REPS)
    model.mlp_int8 = True
    try:
        q, cond, lq = run("nerf_mlp_int8_bfloat16", model, renderer, nerf_fn,
                          "auto", 1)
    finally:
        model.mlp_int8 = False
    d_rgb = nerf_diff(q, plain, ("rgb",))
    good = (cond.mlp_int8 and sum(lq.values()) == 0
            and all(bool(torch.isfinite(q[p][k]).all())
                    for p in ("coarse", "fine") for k in ("rgb", "depth"))
            and d_rgb < MLP_INT8_RGB_TOL)
    print(f"  mlp_int8 (use_fused_mlp auto, so the plain route: 0 launches) "
          f"rgb vs bf16 plain max|diff| {d_rgb:.3e} (limit "
          f"{MLP_INT8_RGB_TOL}); {results['nerf_mlp_int8_bfloat16']['median_s']:.4f}"
          f" s against {results['nerf_plain_bfloat16']['median_s']:.4f} s "
          f"{'ok' if good else 'FAILED'}", flush=True)
    ok &= good
    results["mlp_int8_rgb_vs_bf16"] = d_rgb
    M, K, N = W8A8_SHAPE
    g = torch.Generator().manual_seed(5)
    x = torch.randn((M, K), generator=g)
    w = torch.randn((K, N), generator=g)
    xq, _ = quant.quantize_rows(x)
    wq, _ = quant.quantize_cols(w)
    acc_card = quant.int_mm(xq.to(device), wq.to(device)).cpu()
    acc_cpu = quant.int_mm(xq, wq)
    same_acc = torch.equal(acc_card, acc_cpu)
    same_out = torch.equal(quant.dot_w8a8(x.to(device), w.to(device)).cpu(),
                           quant.dot_w8a8(x, w))
    print(f"  dot_w8a8 {M}x{K}x{N}: int32 accumulators card == CPU "
          f"{same_acc}; f32 result card == CPU {same_out} "
          f"{'ok' if same_acc else 'FAILED'}", flush=True)
    results["w8a8_exact"] = (same_acc, same_out)
    ok &= same_acc
    del plain, q, cond
    torch.cuda.empty_cache()
    return ok, launches


def serve_spade(device, results):
    """Phase 12 (e): the NeRF flagship with SPADE (f32, SPADE_RAYS rays),
    the card against the same model on the CPU, no kernel launch: the
    field at 16 depths of each ray with the random weights, then the
    render with scale_z in its working range (SPADE_SCALE)."""
    import copy

    import torch

    from pixelnerf_yolo_torch.ops import field_mlp as fm

    model, renderer = build_models(
        device, puts={"model.mlp_coarse.use_spade": True,
                      "model.mlp_fine.use_spade": True},
        dtypes=("float32",))["float32"]
    cpu_model = copy.deepcopy(model).to("cpu")
    cpu_r = dataclasses.replace(renderer, device="cpu")
    images, poses, focal, rays = flagship_scene(1, SPADE_RAYS, device)
    z = torch.linspace(0.8, 1.8, 16, device=device)
    pts = (rays[0, :, None, :3] + z[:, None] * rays[0, :, None, 3:6])
    pts = pts.reshape(1, -1, 3)
    vd = rays[0, :, None, 3:6].expand(-1, 16, 3).reshape(1, -1, 3)
    draws = renderer.draw(SPADE_RAYS, torch.Generator().manual_seed(3),
                          "cpu")
    fm.reset_launches()
    ok, worst = True, {}
    for stage in ("field", "render"):
        if stage == "render":
            with torch.no_grad():
                for m in (model, cpu_model):
                    for lin in (*m.mlp_coarse.scale_z, *m.mlp_fine.scale_z):
                        lin.weight.mul_(SPADE_SCALE)
        with torch.no_grad():
            cond = model.encode(images, poses, focal)
            cpu_cond = cpu_model.encode(images, poses, focal)
            if stage == "field":
                pairs = [(model.forward(cond, pts, coarse=c, viewdirs=vd),
                          cpu_model.forward(cpu_cond, pts.cpu(), coarse=c,
                                            viewdirs=vd.cpu()))
                         for c in (True, False)]
            else:
                out = renderer(model, cond, rays, draws=draws)
                ref = cpu_r(cpu_model, cpu_cond, rays.cpu(), draws=draws)
                pairs = [(out[p][k], ref[p][k]) for p in ("coarse", "fine")
                         for k in ("rgb", "depth")]
        worst[stage] = 0.0
        for a, b in pairs:
            d = (a.cpu() - b).abs().max().item()
            scale = max(1.0, b.abs().max().item())
            worst[stage] = max(worst[stage], d / scale)
            ok &= bool(torch.isfinite(a).all()) and d <= SPADE_TOL * scale
    lk = dict(fm.variant_launches)
    ok &= sum(lk.values()) == 0
    print(f"SPADE NeRF NS=1 f32: card vs CPU, the field at {pts.shape[1]} "
          f"points {worst['field']:.3e} of max(1, max|cpu|), the render "
          f"of {SPADE_RAYS} rays (scale_z x {SPADE_SCALE:.3g}) "
          f"{worst['render']:.3e} (tol {SPADE_TOL}); launches {lk} "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    results["spade_card_vs_cpu"] = worst
    del model, cpu_model
    torch.cuda.empty_cache()
    return ok, {"serve_spade": lk}


def serve_export(nerf, yolo, device, results):
    """Phase 12 (f): serve.export_render of the bf16 YOLO flagship and the
    bf16 NeRF flagship at NS=1 (SERVE_RAYS rays each), saved, loaded and
    run: bitwise the live render, with the live render's launches."""
    import torch

    from pixelnerf_yolo_torch import serve
    from pixelnerf_yolo_torch.config.flagship import flagship_conf
    from pixelnerf_yolo_torch.ops import field_mlp as fm

    ok, launches = True, {}
    for label, models, conf_args in (
            ("yolo", yolo, dict(yolo=True, backbone="custom")),
            ("nerf", nerf, {})):
        model, _ = models["bfloat16"]
        model.use_fused_mlp = "auto"
        conf = flagship_conf(compute_dtype="bfloat16", **conf_args)
        fn, _ = serve.build_render_fn(conf, model)
        g = torch.Generator(device=device).manual_seed(6)
        if label == "yolo":
            _, rays, _ = yolo_serve_render(model, models["bfloat16"][1],
                                           device, "auto")
            images, poses, focal = yolo_scene(3, YOLO_SIZE)[:3]
        else:
            images, poses, focal, rays = flagship_scene(1, SERVE_RAYS,
                                                        device)
        images, poses, focal = (torch.as_tensor(x).to(device)
                                for x in (images, poses, focal))
        args = (images, poses, focal, rays,
                *serve.make_draws(fn, images, rays, g))
        t0 = time.perf_counter()
        blob = serve.export_render(conf, model, args)
        t1 = time.perf_counter()
        call, header = serve.load_render(blob)
        t2 = time.perf_counter()
        fm.reset_launches()
        with torch.no_grad():
            live, live_secs, _ = timed(lambda: fn(*args), SERVE_REPS)
        live_launches = {k: v // (SERVE_REPS + 1)
                         for k, v in fm.variant_launches.items()}
        fm.reset_launches()
        got, secs, peak = timed(lambda: call(*args), SERVE_REPS)
        loaded = {k: v // (SERVE_REPS + 1)
                  for k, v in fm.variant_launches.items()}
        leaves = ([live] if isinstance(live, torch.Tensor) else
                  [live[p][k] for p in live for k in live[p]])
        got_leaves = ([got] if isinstance(got, torch.Tensor) else
                      [got[p][k] for p in got for k in got[p]])
        same = len(leaves) == len(got_leaves) and all(
            torch.equal(a, b) for a, b in zip(leaves, got_leaves))
        good = (same and sum(loaded.values()) > 0 and loaded == live_launches
                and sum(v % (SERVE_REPS + 1)
                        for v in fm.variant_launches.values()) == 0)
        launches[f"serve_export_{label}"] = loaded
        results[f"export_{label}"] = serve_line(
            f"exported {label} bf16 {SERVE_RAYS} rays", secs, peak, loaded,
            f"; artifact {len(blob) / 2**20:.1f} MiB, export {t1 - t0:.1f} s,"
            f" load {t2 - t1:.1f} s; the live render "
            f"{statistics.median(live_secs):.4f} s")
        print(f"  loaded program == live render bitwise: {same}; launches "
              f"loaded {loaded} live {live_launches} "
              f"{'ok' if good else 'FAILED'}", flush=True)
        ok &= good
        del blob, call, live, got
        torch.cuda.empty_cache()
    return ok, launches


def serving_path(device):
    """Phase 12: the serving modes.  Returns (ok, launches by path,
    results)."""
    import torch

    t0 = time.perf_counter()
    results, launches = {}, {}
    nerf = build_models(device)
    yolo = build_models(device, out_scale=1.0, yolo=True, backbone="custom")
    ok = True
    for step in (lambda: serve_yolo(yolo, device, results),
                 lambda: serve_gate(nerf, device, results),
                 lambda: serve_int8(nerf, yolo, device, results),
                 lambda: serve_export(nerf, yolo, device, results)):
        good, lk = step()
        ok &= good
        launches.update(lk)
    del nerf, yolo
    torch.cuda.empty_cache()
    good, lk = serve_spade(device, results)
    ok &= good
    launches.update(lk)
    print(f"phase 12: {time.perf_counter() - t0:.1f} s", flush=True)
    return ok, launches, results


# -- phase 13: checkpoint interchange ----------------------------------------

# the renders held bitwise between a model and the model loaded from its
# converted checkpoint: the YOLO flagship through pre_combine_pe +
# post_combine, the NeRF flagship at NS=1 through full_pe
INTERCHANGE_RAYS = 16384


def reference_checkpoint(model, path):
    """Save the model's weights as a reference PixelNeRFNet checkpoint: its
    state_dict (the port's keys are the reference's) with the reference's
    non-persistent buffers added."""
    import torch

    from pixelnerf_yolo_torch.convert import REFERENCE_BUFFERS

    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    for name in REFERENCE_BUFFERS[:-1]:
        sd[name] = torch.zeros(1, 3)
    torch.save(sd, path)


def convert_quietly(argv) -> str:
    """convert.main(argv) with its key lists summarized: (the count of
    ignored keys, the warnings' heads)."""
    import io
    import warnings

    from pixelnerf_yolo_torch import convert

    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        convert.main(argv)
    ignored = [ln.split(":")[0] for ln in out.getvalue().splitlines()
               if ln.startswith("ignored")]
    heads = [str(w.message)[:60] for w in caught]
    return f"{'; '.join(ignored) or 'nothing ignored'}; warnings: {heads}"


def interchange_one(label, device, tmp, conf_args, render_fn):
    """Convert one flagship's reference checkpoint with the CLI, load it
    into a fresh model on the card, and hold the kernel render of each
    bitwise.  Returns (ok, launches of the converted model's render)."""
    import argparse

    import torch

    from pixelnerf_yolo_torch.config.flagship import flagship_conf_text
    from pixelnerf_yolo_torch.config.hocon import parse_string
    from pixelnerf_yolo_torch.models import make_model
    from pixelnerf_yolo_torch.ops import field_mlp as fm
    from pixelnerf_yolo_torch.train import checkpoints

    out_scale = 1.0 if conf_args.get("yolo") else 0.05
    model, renderer = build_models(device, out_scale=out_scale,
                                   dtypes=("bfloat16",),
                                   **conf_args)["bfloat16"]
    text = flagship_conf_text(compute_dtype="bfloat16", **conf_args)
    conf_path = os.path.join(tmp, f"{label}.conf")
    with open(conf_path, "w") as f:
        f.write(text)
    src = os.path.join(tmp, f"{label}_reference")
    reference_checkpoint(model, src)
    args = argparse.Namespace(checkpoints_path=os.path.join(tmp, "ckpt"),
                              name=label, resume=True)
    summary = convert_quietly([
        "--torch_ckpt", src, "--conf", conf_path, "--out",
        os.path.join(checkpoints.ckpt_dir(args), "pixel_nerf_latest"),
        "--seed", "0", "--device", str(device)])
    fresh = make_model(parse_string(text).get_config("model"), device=device,
                       seed=1)
    loaded = checkpoints.load_weights(args, fresh)
    want = render_fn(model, renderer)
    fm.reset_launches()
    got = render_fn(fresh, renderer)
    launches = dict(fm.variant_launches)
    flat = [(k, got[k], want[k]) for k in got] if isinstance(got, dict) \
        else [("out", got, want)]
    same = all(torch.equal(a, b) for _, a, b in flat)
    finite = all(bool(torch.isfinite(a.float()).all()) for _, a, _ in flat)
    ok = loaded and same and finite
    print(f"  {label}: convert --torch_ckpt ({summary}); load_weights "
          f"{'ok' if loaded else 'FAILED'}; render of the converted model "
          f"{'bitwise equal' if same else 'DIFFERS'} to the source's "
          f"({', '.join(k for k, _, _ in flat)}); launches {launches}",
          flush=True)
    del model, fresh
    torch.cuda.empty_cache()
    return ok, launches


def interchange_path(device):
    """Phase 13.  Returns (ok, launches by path)."""
    import importlib.util
    import tempfile

    import numpy as np
    import torch

    from pixelnerf_yolo_torch.config.hocon import parse_file

    t0 = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))

    def yolo_out(model, renderer):
        return yolo_render(model, renderer, INTERCHANGE_RAYS, device,
                           "auto")[0]

    def nerf_out(model, renderer):
        out, _ = render({"bfloat16": (model, renderer)}, 1, "bfloat16",
                        INTERCHANGE_RAYS, device, "auto")
        return {f"{p}.{k}": out[p][k] for p in ("coarse", "fine")
                for k in ("rgb", "depth")}

    ok, launches = True, {}
    with tempfile.TemporaryDirectory() as tmp:
        good, launches["interchange_yolo"] = interchange_one(
            "yolo", device, tmp, {"yolo": True, "backbone": "custom"},
            yolo_out)
        good &= (launched(launches["interchange_yolo"], "pre_combine_pe") > 0
                 and launched(launches["interchange_yolo"],
                              "post_combine") > 0)
        ok &= good
        good, launches["interchange_nerf"] = interchange_one(
            "nerf", device, tmp, {}, nerf_out)
        good &= launched(launches["interchange_nerf"], "full_pe") > 0
        ok &= good

    # the card recipes' in-memory YOLO scenes (no imageio or cv2 needed)
    spec = importlib.util.spec_from_file_location(
        "torch_convergence", os.path.join(here, "scripts",
                                          "torch_convergence.py"))
    tc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tc)
    train, val, test = tc.yolo_scenes(parse_file(os.path.join(
        here, "conf", "exp", "yolo.conf")))
    item = train.base_dset[0]
    boxes = sum(int((grid[0][..., 0] == 1).sum())
                for scene in train.base_dset.items for grid in scene["bboxes"])
    good = (len(train) == 2 and len(val) == len(test) == 1
            and item["images"].shape == (10, 3, 121, 128)
            and bool(np.isfinite(item["images"]).all()) and boxes == 40)
    print(f"  in-memory YOLO scenes (scripts/torch_convergence.py): "
          f"{len(train)} train / {len(val)} val / {len(test)} test, images "
          f"{item['images'].shape}, poses {item['poses'].shape}, focal "
          f"{item['focal'].tolist()}, {boxes} boxes in the grids "
          f"{'ok' if good else 'FAILED'}", flush=True)
    ok &= good
    torch.cuda.empty_cache()
    print(f"phase 13: {time.perf_counter() - t0:.1f} s", flush=True)
    return ok, launches


# -- phase 14: the model configurations ---------------------------------------

# (a) the conv encoder's NeRF renders: NS=1 through full_pe, NS=2 through
# pre_combine_pe + post_combine, at the flagship's renders' ray counts
CONV_RENDERS = [(1, "bfloat16", 65536), (1, "float32", 65536),
                (2, "bfloat16", 16384), (2, "float32", 16384)]
# (b) feature_scale on the resnet34 flagship, NS=1
FEATURE_SCALES = (0.5, 2.0)
SCALE_RENDERS = [(1, "bfloat16", 16384), (1, "float32", 16384)]
# (c) the global encoder (resnet34 beside the spatial resnet34, a 128-d
# global latent: the MLP's latent is 640 wide)
GLOBAL_PUTS = {"model.use_global_encoder": True,
               "model.global_encoder": {"backbone": "resnet34",
                                        "pretrained": False,
                                        "latent_size": 128}}
GLOBAL_RENDERS = [(2, "bfloat16", 16384), (2, "float32", 16384)]
# (d) ImplicitNet with the JAX package's defaults; no spatial encoder
IMPLICIT_PUTS = {"model.mlp_coarse": {"type": "mlp"},
                 "model.mlp_fine": {"type": "mlp"}}
NO_ENCODER_PUTS = {"model.use_encoder": False}
# card against CPU: rays, field points and the f32 limit, x max(1,
# max|cpu|)
CPU_RAYS, CPU_POINTS, CPU_TOL = 1024, 4096, 1e-4
# (e) one training step at the train_nerf schema
OPTION_TRAIN_RAYS = 2048
OPTION_TRAIN_TIMED = 3
# (f) NDC rays, card against CPU
NDC_TOL = 1e-6


def every_launched(launches, kinds, dtypes=("bfloat16", "float32")) -> bool:
    import torch

    from pixelnerf_yolo_torch.ops import field_mlp as fm

    return all(launched(launches, k, fm.variant(k, getattr(torch, d))) > 0
               for k in kinds for d in dtypes)


def card_vs_cpu(label, device, ns, puts, n_rays=CPU_RAYS) -> bool:
    """An f32 render of the flagship with the conf keys of puts, on the
    card and on the CPU, from the same weights and draws: rgb and depth
    of both passes within CPU_TOL x max(1, max|cpu|); and both MLPs'
    field outputs at CPU_POINTS points of the scene, which hold the field
    where random weights leave a pass all empty or all opaque."""
    import torch

    from pixelnerf_yolo_torch.config.flagship import flagship_conf
    from pixelnerf_yolo_torch.models import make_model
    from pixelnerf_yolo_torch.render import make_renderer

    model, renderer = build_models(device, puts=puts,
                                   dtypes=("float32",))["float32"]
    model.use_fused_mlp = "auto"
    conf = flagship_conf(compute_dtype="float32")
    for key, value in puts.items():
        conf.put(key, value)
    cpu = make_model(conf.get_config("model"), device="cpu",
                     load_pretrained=False)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    images, poses, focal, rays = flagship_scene(ns, n_rays, device)
    draws = renderer.draw(rays.shape[1], torch.Generator().manual_seed(3),
                          "cpu")
    g = torch.Generator().manual_seed(4)
    xyz = torch.rand((1, CPU_POINTS, 3), generator=g) * 0.8 - 0.4
    vd = torch.nn.functional.normalize(
        torch.randn((1, CPU_POINTS, 3), generator=g), dim=-1)
    with torch.no_grad():
        cond = model.encode(images, poses, focal)
        cond_cpu = cpu.encode(images, poses, focal)
        got = renderer(model, cond, rays, draws=draws)
        ref = make_renderer(conf, device="cpu")(cpu, cond_cpu, rays.cpu(),
                                                draws=draws)
        for coarse in (True, False):
            got[f"field_{'coarse' if coarse else 'fine'}"] = {
                "out": model.forward(cond, xyz.to(device), coarse=coarse,
                                     viewdirs=vd.to(device))}
            ref[f"field_{'coarse' if coarse else 'fine'}"] = {
                "out": cpu.forward(cond_cpu, xyz, coarse=coarse,
                                   viewdirs=vd)}
    ok = True
    for p in ("coarse", "fine", "field_coarse", "field_fine"):
        for k in ref[p]:
            a, b = got[p][k].float().cpu(), ref[p][k].float()
            tol = CPU_TOL * max(1.0, b.abs().max().item())
            err = (a - b).abs().max().item()
            good = bool(torch.isfinite(a).all()) and err <= tol
            ok &= good
            print(f"  {label} NS={ns} f32 {n_rays} rays, card vs CPU "
                  f"{p}.{k}: max|diff| {err:.3e} tol {tol:.3e} "
                  f"{'ok' if good else 'FAILED'}", flush=True)
    del model, cpu
    torch.cuda.empty_cache()
    return ok


def option_train_step(label, device, dtype_name, tmp, ns, puts, kinds):
    """Phase 14 (e): one step at the train_nerf schema with OPTION_TRAIN_RAYS
    rays on each route from the same weights, pixels and draws, held as
    phase 9 holds them; the kernel route launches each of kinds twice (none
    when kinds is empty); then ms/step (median of OPTION_TRAIN_TIMED after
    one warm-up) and peak memory on the kernel route.  Returns (ok,
    launches of its kernel-route step)."""
    import torch

    from pixelnerf_yolo_torch.ops import field_mlp as fm

    cdt = getattr(torch, dtype_name)
    trainer, model, batch, draws = nerf_trainer(
        device, dtype_name, os.path.join(tmp, label), ns, OPTION_TRAIN_RAYS,
        puts=puts)
    init = {k: t.clone() for k, t in model.state_dict().items()}
    pixel_rng = trainer._rng.bit_generator.state

    def restart():
        model.load_state_dict(init)
        trainer.init_opt_state(model.parameters())
        trainer._rng.bit_generator.state = pixel_rng

    kernel, plain = nerf_both_routes(trainer, model, batch, draws, restart)
    launches = kernel[2]
    want = {k: 2 for k in kinds}
    good = (all(launched(launches, k, fm.variant(k, cdt)) == n
                for k, n in want.items())
            and sum(launches.values()) == 2 * len(kinds)
            and sum(plain[2].values()) == 0)
    print(f"train {label} NS={ns} {dtype_name}: launches of one kernel-route "
          f"step {launches} (expected {want or 'none'}); plain route "
          f"{plain[2]} {'ok' if good else 'FAILED'}", flush=True)
    agree, _ = nerf_agreement(f"{label}, {OPTION_TRAIN_RAYS} rays",
                              dtype_name, kernel, plain)
    good &= agree
    restart()
    model.use_fused_mlp = "auto"
    train_steps(trainer, batch, 1, draws=draws)
    torch.cuda.reset_peak_memory_stats()
    times, _ = train_steps(trainer, batch, OPTION_TRAIN_TIMED,
                              draws=draws)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  {label} {dtype_name}: {statistics.median(times):.3f} ms/step "
          f"median of {OPTION_TRAIN_TIMED} (min {min(times):.3f}, max "
          f"{max(times):.3f}); peak memory {peak:.2f} GiB", flush=True)
    del trainer, model, init, kernel, plain
    torch.cuda.empty_cache()
    return good, launches


def ndc_check(device) -> bool:
    """Phase 14 (f): NDC rays on the card against the CPU."""
    import numpy as np
    import torch

    from pixelnerf_yolo_torch.utils.camera import gen_rays

    rng = np.random.default_rng(0)
    poses = np.stack([np.eye(4, dtype=np.float32)] * 2)
    poses[:, :3, 3] = rng.normal(size=(2, 3)) * 0.1
    poses[:, 2, 3] += 2.0
    p = torch.from_numpy(poses)
    got = gen_rays(p.to(device), 128, 96, torch.tensor([120.0, 118.0]), 0.5,
                   3.0, ndc=True).cpu()
    ref = gen_rays(p, 128, 96, torch.tensor([120.0, 118.0]), 0.5, 3.0,
                   ndc=True)
    err = (got - ref).abs().max().item()
    good = (got.shape == (2, 96, 128, 8) and bool(torch.isfinite(got).all())
            and err <= NDC_TOL)
    print(f"  NDC rays (2 x 96 x 128): card vs CPU max|diff| {err:.3e} tol "
          f"{NDC_TOL} {'ok' if good else 'FAILED'}", flush=True)
    return good


def options_path(device):
    """Phase 14.  Returns (ok, launches by path)."""
    import shutil
    import tempfile

    import torch

    t0 = time.perf_counter()
    ok, paths = True, {}
    # (a) the conv encoder, kernel route then plain; lin_out keeps its
    # scale: at 1/20 its random weights leave the scene nearly empty
    # (mean coarse depth 0.02, 0.25 at 1; an opaque ray reads 0.8-1.8)
    conv = build_models(device, out_scale=1.0, backbone="conv")
    out, paths["conv"] = nerf_path(conv, CONV_RENDERS, device, "conv")
    good = every_launched(paths["conv"], ("full_pe", "pre_combine_pe",
                                          "post_combine"))
    if not good:
        print("FAILED: a kernel of the conv-encoder path was never launched")
    ok &= good and compare_plain(conv, CONV_RENDERS, out, device, "conv")
    del conv, out
    torch.cuda.empty_cache()
    # (b) feature_scale
    for scale in FEATURE_SCALES:
        label = f"feature_scale={scale}"
        models = build_models(device,
                              puts={"model.encoder.feature_scale": scale})
        out, paths[label] = nerf_path(models, SCALE_RENDERS, device, label)
        good = every_launched(paths[label], ("full_pe",))
        if not good:
            print(f"FAILED: full_pe never launched on the {label} path")
        ok &= good and compare_plain(models, SCALE_RENDERS, out, device,
                                     label)
        del models, out
        torch.cuda.empty_cache()
    # (c) the global encoder: the kernels do not take its latent
    models = build_models(device, puts=GLOBAL_PUTS)
    out, paths["global"] = nerf_path(models, GLOBAL_RENDERS, device,
                                     "global encoder")
    field = sum(n for k, n in paths["global"].items() if k != GATHER)
    good = field == 0
    print(f"  global encoder at use_fused_mlp = auto: {field} field-MLP "
          f"launches (must be 0) {'ok' if good else 'FAILED'}", flush=True)
    ok &= good and compare_plain(models, GLOBAL_RENDERS, out, device,
                                 "global encoder")
    for dtype_name in ("bfloat16", "float32"):
        model = models[dtype_name][0]
        ok &= not any(model._fuses(m, ns) for m in (model.mlp_coarse,
                                                    model.mlp_fine)
                      for ns in (1, 2))
    del models, out
    torch.cuda.empty_cache()
    ok &= card_vs_cpu("global encoder", device, 2, GLOBAL_PUTS)
    # (d) ImplicitNet and the encoder-free model (plain route only)
    ok &= card_vs_cpu("ImplicitNet", device, 1, IMPLICIT_PUTS)
    ok &= card_vs_cpu("no encoder", device, 1, NO_ENCODER_PUTS)
    # (e) one training step
    tmp = tempfile.mkdtemp()
    try:
        for dtype_name in ("bfloat16", "float32"):
            sfx = "" if dtype_name == "bfloat16" else "_f32"
            good, paths["train_conv" + sfx] = option_train_step(
                "conv", device, dtype_name, tmp, 1,
                {"model.encoder.backbone": "conv"}, ("full_pe",))
            ok &= good
            good, paths["train_global" + sfx] = option_train_step(
                "global", device, dtype_name, tmp, 2, GLOBAL_PUTS, ())
            ok &= good
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # (f) NDC
    ok &= ndc_check(device)
    print(f"phase 14: {time.perf_counter() - t0:.1f} s", flush=True)
    return ok, paths


# -- phase 15: PointRend ------------------------------------------------------

POINTREND_PHOTO = (480, 640)
FPN_TOL = 1e-4  # x max|cpu| of each level
BOX_TOL = 1e-2  # px
MASK_AGREE = 0.999  # share of equal mask pixels (a logit near 0 may flip)


def pointrend_path(device) -> bool:
    """Phase 15: the PointRend predictor at detectron2's sizes on a seeded
    photo, on the card against the port on the CPU (f32, TF32 off)."""
    import numpy as np
    import torch

    from pixelnerf_yolo_torch.segment import PointRendPredictor, random_params
    from pixelnerf_yolo_torch.segment.backbone import backbone_apply

    t0 = time.perf_counter()
    params = random_params(np.random.default_rng(0))
    img = (np.random.default_rng(1).random(POINTREND_PHOTO + (3,))
           * 255).astype(np.uint8)
    card = PointRendPredictor(params, score_thresh=0.0, device=device)
    cpu = PointRendPredictor(params, score_thresh=0.0, device="cpu")
    ok = True
    with torch.no_grad():
        x_card, hw = card._preprocess(img)
        x_cpu, _ = cpu._preprocess(img)
        f_card = backbone_apply(card.params["backbone"], x_card)
        f_cpu = backbone_apply(cpu.params["backbone"], x_cpu)
    for k in sorted(f_cpu):
        err = (f_card[k].cpu() - f_cpu[k]).abs().max().item()
        tol = FPN_TOL * f_cpu[k].abs().max().item()
        good = err <= tol
        ok &= good
        print(f"  PointRend input {tuple(x_card.shape)} (resized to {hw}), "
              f"FPN {k} {tuple(f_card[k].shape)}: card vs CPU max|diff| "
              f"{err:.3e} tol {tol:.3e} {'ok' if good else 'FAILED'}",
              flush=True)
    del f_card, f_cpu
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    got = card.detect(img)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t1
    t1 = time.perf_counter()
    ref = cpu.detect(img)
    t_cpu = time.perf_counter() - t1
    n = len(ref["boxes"])
    # pair each card detection with the CPU's of its class and nearest box
    # (scores that tie to rounding may swap places)
    dist = np.abs(got["boxes"][:, None, :] - ref["boxes"][None, :, :]).max(-1)
    dist[got["classes"][:, None] != ref["classes"][None, :]] = np.inf
    pair = dist.argmin(1) if n else np.zeros(0, np.int64)
    one_to_one = len(set(pair.tolist())) == n == len(got["boxes"])
    box_err = float(dist[np.arange(len(pair)), pair].max()) if n else 0.0
    same = (got["masks"] == ref["masks"][pair]).mean() if n else 1.0
    good = (n > 0 and one_to_one and box_err <= BOX_TOL
            and same >= MASK_AGREE)
    ok &= good
    print(f"  PointRend {POINTREND_PHOTO} photo, score_thresh 0: "
          f"{len(got['boxes'])} detections on the card, {n} on the CPU, "
          f"paired one to one by class: {one_to_one}; box max|diff| "
          f"{box_err:.3e} px (tol {BOX_TOL}); masks equal on "
          f"{100 * same:.4f}% of pixels (min {100 * MASK_AGREE}%); detect "
          f"{t_card:.3f} s on the card, {t_cpu:.3f} s on the CPU "
          f"{'ok' if good else 'FAILED'}", flush=True)
    print(f"phase 15: {time.perf_counter() - t0:.1f} s", flush=True)
    return ok


# -- phase 16: the multi-device path ------------------------------------------

# (a) world size 1 over NCCL: the flagship renders of phases 3-4 through
# bind_parallel against the unbound ones, bitwise, and one train_yolo step
# through make_train_mesh(1) against the unbound step (beside a second
# unbound step, the witness of what bitwise can mean there).  (b) two
# ranks sharing cuda:0 (NCCL refuses two ranks on one device, so the group
# runs on gloo, which parallel/collectives.py hands CUDA tensors through
# the host): the renders at 16,384 rays on the kernel route against the
# world-1 render at phase 3's limits, each rank's launches, and train_yolo
# steps at mesh (data 1, rays 2) and (data 1, rays 1, model 2) against the
# world-1 step: f32 within (1e-5, 1e-4) (the reduction order only), bf16
# within phase 8's limits (the split blocks sum the ranks' partial products
# in f32 and round once, as XLA does); each step must launch
# pre_combine_pe and post_combine of its dtype's kernel.
PAR_RAYS = 16384
PAR_NERF_RAYS = 65536  # (a)'s NeRF render, phase 3's
PAR_RANKS = 2
# timed steps a (b) configuration after its compared step: tensor
# parallelism sends each block's (393,216 x 512) activations through gloo
# and the host twice a step, ~5-10 s (PR 13), so it takes one
PAR_TIMED = {1: 2, 2: 1}
# (a) f32: two unbound steps differ by the latent gather's atomics
# (5.1e-6, PR 13): the mesh step is held to PAR_WITNESS x that reading
PAR_WITNESS = 2.0
PAR_TIMEOUT = 240  # seconds the ranks of (b) may take
# (b) configurations: (label, compute dtype, model_parallel)
PAR_STEPS = [("rays2_f32", "float32", 1), ("model2_f32", "float32", 2),
             ("rays2_bf16", "bfloat16", 1), ("model2_bf16", "bfloat16", 2)]


def par_models(device):
    """The (a) / (b) renders' models: the YOLO flagship and the NeRF
    flagship and its viewdirs variant, bf16, weights from seed 0."""
    yolo = build_models(device, out_scale=1.0, yolo=True, backbone="custom",
                        dtypes=("bfloat16",))["bfloat16"]
    nerf = build_models(device, dtypes=("bfloat16",))
    vd = build_models(device, dtypes=("bfloat16",), use_code_viewdirs=True)
    return yolo, nerf, vd


def par_renders(device, yolo, nerf, vd, mesh, n_nerf):
    """The three renders (YOLO NS=3, NeRF NS=1 at n_nerf rays, viewdirs
    NS=2), unbound (mesh None) or through bind_parallel on mesh, each from
    a generator seeded 3 on the kernel route: {label: (outputs, s)}."""
    import torch

    from pixelnerf_yolo_torch.parallel.render import bind_parallel

    out = {}
    model, renderer = yolo
    model.use_fused_mlp = "auto"
    images, poses, focal, c, target = yolo_scene(3, YOLO_SIZE)
    from pixelnerf_yolo_torch.utils.camera import gen_rays_yolo

    with torch.no_grad():
        cond = model.encode(images, poses, focal, c=c)
    rays = gen_rays_yolo(torch.from_numpy(target).to(device), YOLO_SIZE,
                         YOLO_SIZE, focal[0], c[0], YOLO_NEAR,
                         YOLO_FAR).reshape(1, -1, 8)[:, :PAR_RAYS]
    jobs = [("yolo", model, renderer, cond, rays)]
    for label, models, ns, n in (("nerf", nerf, 1, n_nerf),
                                 ("viewdirs", vd, 2, PAR_RAYS)):
        m, r = models["bfloat16"]
        m.use_fused_mlp = "auto"
        images, poses, focal, nrays = flagship_scene(ns, n, device)
        with torch.no_grad():
            ncond = m.encode(images, poses, focal)
        jobs.append((label, m, r, ncond, nrays))
    for label, m, r, cnd, rys in jobs:
        g = torch.Generator(device=device).manual_seed(3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mesh is None:
            got = r(m, cnd, rys, generator=g)
        else:
            got = bind_parallel(r, m, mesh=mesh, want_weights=False)(
                cnd, rys, generator=g)
        torch.cuda.synchronize()
        out[label] = (got, time.perf_counter() - t0)
    return out


def par_flat(out) -> dict:
    """A render's outputs as {name: f32 CPU tensor}."""
    if isinstance(out, dict):
        return {f"{p}.{k}": v.float().cpu() for p, d in out.items()
                for k, v in d.items()}
    # YOLO: (B, A, 7) through bind_parallel, (1, B, A, 7) unbound
    return {"out": out.float().cpu().reshape(-1, *out.shape[-2:])}


def par_step(device, dtype_name, tmp, mesh=None):
    """One train_yolo-point step (phase 8's conf, scene, weights, view
    choice and draws) through make_trainer on mesh: (losses, {name: the
    gradient in the single-device layout}, trainer, batch, u)."""
    import torch

    from pixelnerf_yolo_torch import parallel
    from pixelnerf_yolo_torch.config.flagship import train_yolo_conf
    from pixelnerf_yolo_torch.data import DataLoader
    from pixelnerf_yolo_torch.models import make_model
    from pixelnerf_yolo_torch.render import make_renderer
    from pixelnerf_yolo_torch.train import make_trainer

    conf = train_yolo_conf(dtype_name)
    model = make_model(conf.get_config("model"), device=device, seed=0)
    perturb_fc1(model, torch.Generator().manual_seed(2))
    renderer = make_renderer(conf, device=device)
    dset = train_dataset(conf)
    batch = next(iter(DataLoader(dset, batch_size=1)))
    trainer = make_trainer(train_args(tmp), conf, dset, dset, model,
                           renderer, [TRAIN_NS], device=device, mesh=mesh)
    R = conf.get_int("yolo.ray_batch_size")
    u = torch.rand((R, renderer.n_coarse), device=device,
                   generator=torch.Generator(device=device).manual_seed(5))
    _, losses = train_steps(trainer, batch, 1, u=u)
    group = parallel.model_group(model)
    grads = {n: None if p.grad is None else parallel.gather_tp(
        p.grad.detach(), parallel._tp_dim(n, p.grad.ndim), group).cpu()
        for n, p in model.named_parameters()}
    return losses[0], grads, trainer, batch, u


def par_kernels(launches: dict, dtype_name: str) -> bool:
    """Whether a YOLO step launched pre_combine_pe and post_combine of its
    dtype's kernel (the route did not fall back to the plain field)."""
    import torch

    from pixelnerf_yolo_torch.ops import field_mlp as fm

    return all(launched(launches, k, fm.variant(k, getattr(torch, dtype_name)))
               > 0 for k in ("pre_combine_pe", "post_combine"))


def par_compare(got, ref):
    """(max relative loss diff, worst gradient relative L2, its name,
    whether the losses are finite and the same parameters have
    gradients) of a step's (losses, gradients) against ref's."""
    lk, gk = got
    lp, gp = ref
    loss_err = max(abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-30) for k in lp)
    worst, name, missing = grad_diff(gk, gp)
    ok = all(math.isfinite(v) for v in lk.values()) and not missing
    return loss_err, worst, name, ok


def par_world1(device, tmp):
    """Phase 16 (a) in this process: returns (ok, launches, references for
    (b): renders and the f32 / bf16 world-1 steps)."""
    import torch
    import torch.distributed as dist

    from pixelnerf_yolo_torch import parallel
    from pixelnerf_yolo_torch.ops import field_mlp as fm

    ok = True
    parallel.init_process_group(0, 1, "cuda", [0],
                                os.path.join(tmp, "store1"))
    try:
        one = torch.ones(1, device=device)
        dist.all_reduce(one)  # the NCCL communicator comes up here
        print(f"phase 16 (a): world size {dist.get_world_size()} over "
              f"{dist.get_backend()} (all_reduce of one {one.item()})",
              flush=True)
        yolo, nerf, vd = par_models(device)
        unbound = par_renders(device, yolo, nerf, vd, None, PAR_NERF_RAYS)
        fm.reset_launches()
        bound = par_renders(device, yolo, nerf, vd, parallel.make_mesh(),
                            PAR_NERF_RAYS)
        launches = dict(fm.variant_launches)
        for label in ("yolo", "nerf"):
            a, b = par_flat(bound[label][0]), par_flat(unbound[label][0])
            diff = max((a[k] - b[k]).abs().max().item() for k in b)
            same = all(torch.equal(a[k], b[k]) for k in b)
            ok &= same
            print(f"  {label} bf16 bind_parallel vs unbound: max|diff| "
                  f"{diff:.3e} {'bitwise ok' if same else 'FAILED'} "
                  f"({bound[label][1]:.3f} s vs {unbound[label][1]:.3f} s)",
                  flush=True)
        refs = {"renders": {k: par_flat(v[0]) for k, v in par_renders(
            device, yolo, nerf, vd, None, PAR_RAYS).items()}}
        del yolo, nerf, vd, unbound, bound
        torch.cuda.empty_cache()
        mesh = parallel.make_train_mesh(batch_size=1)
        for dtype_name in ("float32", "bfloat16"):
            w1 = par_step(device, dtype_name, os.path.join(tmp, "u1"))
            w2 = par_step(device, dtype_name, os.path.join(tmp, "u2"))
            fm.reset_launches()
            sh = par_step(device, dtype_name, os.path.join(tmp, "m1"), mesh)
            launches[f"train_{dtype_name}"] = dict(fm.variant_launches)
            wit = par_compare(w2[:2], w1[:2])
            got = par_compare(sh[:2], w1[:2])
            # the losses bitwise; the gradients bitwise where two unbound
            # steps are, else within PAR_WITNESS x their difference; the
            # kernels launched
            kern = par_kernels(launches[f"train_{dtype_name}"], dtype_name)
            same = (sh[0] == w1[0] and got[3]
                    and got[1] <= PAR_WITNESS * wit[1] and kern)
            ok &= same
            print(f"  train_yolo {dtype_name} step on make_train_mesh(1) "
                  f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} vs "
                  f"unbound: losses {sh[0]} vs {w1[0]}, max relative loss "
                  f"diff {got[0]:.3e}, worst gradient relative L2 "
                  f"{got[1]:.3e} ({got[2]}); a second unbound step: "
                  f"{wit[0]:.3e}, {wit[1]:.3e} (held to {PAR_WITNESS}x); "
                  f"launches {launches[f'train_{dtype_name}']} (kernels: "
                  f"{kern}) {'ok' if same else 'FAILED'}", flush=True)
            refs[dtype_name] = w1[:2]
            del w1, w2, sh
            torch.cuda.empty_cache()
    finally:
        parallel.destroy_process_group()
    return ok, launches, refs


def par_rank(rank, world, store, ref_path, out_path):
    """Phase 16 (b) on one rank (spawned): the renders and the steps."""
    import pickle

    import torch

    from pixelnerf_yolo_torch import parallel
    from pixelnerf_yolo_torch.ops import field_mlp as fm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {}
    dev = parallel.init_process_group(rank, world, "cuda", [0] * world,
                                      store)
    try:
        device = torch.device(dev)
        fm.load_library()
        refs = torch.load(ref_path, weights_only=False)
        yolo, nerf, vd = par_models(device)
        assert next(yolo[0].parameters()).device == device
        fm.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        got = par_renders(device, yolo, nerf, vd, parallel.make_mesh(),
                          PAR_RAYS)
        res["render_launches"] = dict(fm.variant_launches)
        res["render_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        res["renders"] = {}
        for label, (out, sec) in got.items():
            a, b = par_flat(out), refs["renders"][label]
            scale = max(1.0, max(t.abs().max().item() for t in b.values()))
            diff = max((a[k] - b[k]).abs().max().item() for k in b)
            finite = all(bool(torch.isfinite(t).all()) for t in a.values())
            res["renders"][label] = (diff, scale, finite, sec,
                                     all(torch.equal(a[k], b[k]) for k in b))
        del yolo, nerf, vd, got
        torch.cuda.empty_cache()
        res["staging"] = par_staging(device)
        res["steps"] = {}
        for label, dtype_name, mp in PAR_STEPS:
            mesh = parallel.make_train_mesh(batch_size=1, model_parallel=mp)
            fm.reset_launches()
            tmp = os.path.join(os.path.dirname(out_path), f"{label}{rank}")
            losses, grads, trainer, batch, u = par_step(device, dtype_name,
                                                        tmp, mesh)
            step_launches = dict(fm.variant_launches)
            cmp = par_compare((losses, grads), refs[dtype_name])
            torch.cuda.reset_peak_memory_stats()
            times, _ = train_steps(trainer, batch, PAR_TIMED[mp], u=u)
            shard = tuple(dict(trainer.model.named_parameters())[
                "mlp_coarse.blocks.0.fc_0.weight"].shape)
            res["steps"][label] = {
                "losses": losses, "loss_err": cmp[0], "grad_err": cmp[1],
                "grad_worst": cmp[2], "complete": cmp[3],
                "launches": step_launches,
                "ms": statistics.median(times), "ms_min": min(times),
                "ms_max": max(times),
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
                "fc_0_shard": shard, "mp": mp}
            del trainer, grads
            torch.cuda.empty_cache()
        res["done"] = True
    finally:
        parallel.destroy_process_group()
        with open(out_path, "wb") as f:
            pickle.dump(res, f)


def par_staging(device, reps=2) -> dict:
    """ms (median of reps, host clock) of one all-reduce over the ranks'
    gloo group, staged through the host: of the train_yolo model's f32
    gradients (28,467,637 values) and of one tensor-parallel block's f32
    activations at the train_yolo point (393,216 x 512)."""
    import torch
    import torch.distributed as dist

    from pixelnerf_yolo_torch.parallel.collectives import all_reduce_

    out = {}
    for label, n in (("the gradients, 108.6 MiB", 28_467_637),
                     ("a TP block's activations, 768 MiB", 393_216 * 512)):
        t = torch.ones(n, device=device)
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            all_reduce_(t, dist.group.WORLD)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[label] = statistics.median(times)
        del t
    return out


def spawn_ranks(fn, world, args, timeout):
    """fn(rank, world, *args) in world spawned processes; returns their
    exit codes (a process still running after timeout seconds is killed
    and reads None)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=fn, args=(r, world, *args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    codes = []
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
            codes.append(None)
        else:
            codes.append(p.exitcode)
    return codes


def parallel_path(device):
    """Phase 16.  Returns (ok, launches by path)."""
    import pickle
    import shutil
    import tempfile

    import torch

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp()
    paths = {}
    try:
        ok, launches, refs = par_world1(device, tmp)
        paths["parallel_world1_renders"] = {
            k: v for k, v in launches.items() if "/" in k}
        for dtype_name in ("float32", "bfloat16"):
            paths[f"parallel_world1_train_{dtype_name}"] = launches[
                f"train_{dtype_name}"]
        ref_path = os.path.join(tmp, "refs.pt")
        torch.save(refs, ref_path)
        del refs
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(PAR_RANKS)]
        codes = spawn_ranks(par_rank_entry, PAR_RANKS,
                            (os.path.join(tmp, "store"), ref_path, tmp),
                            PAR_TIMEOUT)
        print(f"phase 16 (b): {PAR_RANKS} ranks sharing cuda:0 over gloo "
              f"(CUDA tensors staged through the host), exit codes {codes}, "
              f"{time.perf_counter() - t1:.1f} s", flush=True)
        ok &= all(c == 0 for c in codes)
        results = []
        for path in outs:
            with open(path, "rb") as f:
                results.append(pickle.load(f))
        every = ("full_pe", "pre_combine_pe", "post_combine", "pre_combine")
        for r, res in enumerate(results):
            if "done" not in res:
                print(f"FAILED: rank {r} did not finish")
                ok = False
                continue
            rl = res["render_launches"]
            paths[f"parallel_rank{r}_renders"] = rl
            launched_all = all(launched(rl, k) > 0 for k in every)
            ok &= launched_all
            print(f"  rank {r} render launches {rl} (every kernel > 0: "
                  f"{'ok' if launched_all else 'FAILED'}); peak memory "
                  f"{res['render_peak_gib']:.2f} GiB", flush=True)
            for label, (diff, scale, finite, sec, same) in \
                    res["renders"].items():
                tol = RENDER_TOL["bfloat16"] * scale
                good = finite and diff <= tol
                ok &= good
                print(f"  rank {r} {label} bf16 {PAR_RAYS} rays sharded "
                      f"over {PAR_RANKS} vs world 1: max|diff| {diff:.3e} "
                      f"(tol {tol:.3e}; bitwise {same}) in {sec:.3f} s "
                      f"{'ok' if good else 'FAILED'}", flush=True)
            print(f"  rank {r} gloo through the host: " + "; ".join(
                f"all_reduce of {k} {v:.1f} ms" for k, v in
                res["staging"].items()), flush=True)
            for label, st in res["steps"].items():
                paths[f"parallel_rank{r}_{label}"] = st["launches"]
                dtype_name = "float32" if label.endswith("f32") else \
                    "bfloat16"
                loss_tol, grad_tol = TRAIN_TOL[dtype_name]
                within = st["loss_err"] <= loss_tol and \
                    st["grad_err"] <= grad_tol
                # phase 8's limits, and the kernels launched, in both
                # dtypes
                good = (st["complete"] and within
                        and par_kernels(st["launches"], dtype_name))
                ok &= good
                print(f"  rank {r} {label} mesh {st['mesh']} (fc_0 shard "
                      f"{st['fc_0_shard']}): losses {st['losses']}; vs world "
                      f"1 max relative loss diff {st['loss_err']:.3e}, worst "
                      f"gradient relative L2 {st['grad_err']:.3e} "
                      f"({st['grad_worst']}); limits ({loss_tol}, "
                      f"{grad_tol}): {'within' if within else 'OUTSIDE'}; "
                      f"{st['ms']:.3f} ms/step median of "
                      f"{PAR_TIMED[st['mp']]} (min "
                      f"{st['ms_min']:.3f}, max {st['ms_max']:.3f}); peak "
                      f"memory {st['peak_gib']:.2f} GiB; launches "
                      f"{st['launches']} {'ok' if good else 'FAILED'}",
                      flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 16: {time.perf_counter() - t0:.1f} s", flush=True)
    return ok, paths


def par_rank_entry(rank, world, store, ref_path, tmp):
    par_rank(rank, world, store, ref_path,
             os.path.join(tmp, f"rank{rank}.pkl"))


# -- phase 17: profiling --------------------------------------------------------

# The operating points of pixelnerf_yolo_torch/profile_trace.py (bench.py's
# sizes) that phase 17 traces, PROFILE_ITERS iterations each after one
# warm-up; a render's stage times are held to sum to the device busy time
# within PROFILE_SUM_TOL and (no scope) to stay under PROFILE_NO_SCOPE of it.
PROFILE_POINTS = [("nerf", "bfloat16"), ("nerf", "float32"),
                  ("yolo", "bfloat16"), ("vd", "bfloat16"),
                  ("train_yolo", "bfloat16"), ("train_nerf", "bfloat16")]
PROFILE_ITERS = 3
PROFILE_SUM_TOL, PROFILE_NO_SCOPE = 0.01, 0.05


def trace_edges(events) -> dict:
    """Where a capture's device records sit against its ITERATION ranges,
    each of which ends after a sync: ``lead_ms`` (the first record's start
    after the first range's), ``overhang_ms`` (the last record's end after
    the last range's: above 0, the device's stamps run ahead of the host's),
    and the kernel launches the runtime recorded (``launches``) with no
    device record (``lost``), of them the ``trailing`` ones (after the
    last launch that has a record)."""
    from pixelnerf_yolo_torch import profile_trace as pt

    ranges = [e for e in events if e.get("name") == pt.ITERATION
              and e.get("cat") == "user_annotation"]
    dev = [e for e in events if e.get("cat") in pt.DEVICE_CATS]
    kept = {e.get("args", {}).get("correlation") for e in dev}
    calls = sorted((e for e in events if e.get("cat") in pt.LAUNCH_CATS
                    and "Launch" in e.get("name", "")
                    and "correlation" in e.get("args", {})),
                   key=lambda e: e["ts"])
    held = [e["args"]["correlation"] in kept for e in calls]
    out = {"lead_ms": None, "overhang_ms": None, "launches": len(calls),
           "lost": held.count(False),
           "trailing": len(held) - (max((i + 1 for i, h in enumerate(held)
                                          if h), default=0))}
    if ranges and dev:
        out["lead_ms"] = (min(e["ts"] for e in dev)
                          - min(e["ts"] for e in ranges)) / 1e3
        out["overhang_ms"] = (max(e["ts"] + e.get("dur", 0) for e in dev)
                              - max(e["ts"] + e["dur"] for e in ranges)) / 1e3
    return out


def profile_point(device, config, dtype_name, tmp):
    """Phase 17 on one operating point: capture, reduce, print, hold
    (a)-(c).  Returns (ok, the launches of its traced path)."""
    import statistics as st

    import torch

    from pixelnerf_yolo_torch import profile_trace as pt
    from pixelnerf_yolo_torch.ops import field_mlp as fm
    from pixelnerf_yolo_torch.utils.profiling import count_flops

    point = pt.make_point(config, device, os.path.join(tmp, "work"),
                          dtype_name)
    fm.reset_launches()
    meta = pt.capture(point, device, PROFILE_ITERS, tmp, warmup=1)
    launches = dict(fm.variant_launches)
    events = pt.load_trace(meta["trace"])
    os.remove(meta["trace"])
    red = pt.reduce(events, PROFILE_ITERS)
    print(f"profile {config} {dtype_name}: untraced median "
          f"{st.median(meta['untraced_ms']):.3f} ms, traced median "
          f"{st.median(meta['traced_ms']):.3f} ms an iteration "
          f"(untraced {meta['untraced_ms']}, traced {meta['traced_ms']})",
          flush=True)
    pt.print_report(red, meta["flops_by_stage"], 10, dtype_name,
                    meta["nvidia_smi"])
    # (a) every field-MLP kernel launch of the traced iterations is in the
    # trace, under model_inference
    ops, stages, _ = pt.attribute(events)
    field = [s for e, s in zip(ops, stages) if e.get("cat") == "kernel"
             and ("field_mlp_tc" in e["name"] or "field_mlp_f32" in e["name"])]
    rise = sum(meta["launches"].values())
    ok_a = (len(field) == rise and rise > 0
            and all(s == "model_inference" for s in field))
    edges = trace_edges(events)
    # (b) the stage times sum to the busy time; little outside the scopes
    no_scope = red.stages.get(pt.NO_SCOPE, [0.0])[0]
    ok_b = abs(red.stage_ms - red.busy_ms) <= PROFILE_SUM_TOL * red.busy_ms
    render = config in pt.RENDERS
    if render:
        ok_b &= no_scope < PROFILE_NO_SCOPE * red.busy_ms
    print(f"  (a) field-MLP kernel events in the trace {len(field)} (stages "
          f"{sorted(set(field))}), launch counts' rise {rise} "
          f"{meta['launches']}: {'ok' if ok_a else 'FAILED'} (the records "
          f"against the iterations, {time.perf_counter() - STARTED:.0f} s "
          f"into the process: {edges}); (b) stages "
          f"sum {red.stage_ms:.3f} ms vs device busy {red.busy_ms:.3f} ms "
          f"(wall {red.wall_ms:.3f} ms, idle {100 * red.idle_share:.1f}%), "
          f"(no scope) {no_scope:.3f} ms: {'ok' if ok_b else 'FAILED'}",
          flush=True)
    # (c) the FLOP counts
    if render:
        kern = count_flops(point.step)[1]
        point.model.use_fused_mlp = "false"
        plain = count_flops(point.step)[1]
        point.model.use_fused_mlp = "auto"
        k_total, p_total = sum(kern.values()), sum(plain.values())
        fld = sum(v for (_, op), v in kern.items()
                  if op.startswith("pixelnerf_yolo."))
        per_ray = pt.field_flops_per_ray(point.model, point.renderer,
                                         point.cond.num_views_per_obj)
        rays = pt.field_rays(point.renderer, point.cond, point.rays)
        ok_c = k_total == p_total and fld == per_ray * rays
        print(f"  (c) count_flops kernel route {k_total} vs plain route "
              f"{p_total}; the kernels' share {fld} vs field_flops_per_ray "
              f"{per_ray} x {rays} rays evaluated ({point.rays} asked) = "
              f"{per_ray * rays}; {k_total / 1e9 / st.median(meta['untraced_ms']):.3f}"
              f" TFLOP/s: {'ok' if ok_c else 'FAILED'}", flush=True)
    else:
        got = {}
        for fused in ("auto", "false"):
            point.model.use_fused_mlp = fused
            point.step()
            ca = point.trainer.update_cost_analysis()
            got[fused] = ca["flops"] if ca else None
        point.model.use_fused_mlp = "auto"
        ok_c = (got["auto"] is not None and got["false"] is not None
                and got["auto"] >= got["false"] > 0)
        ms = st.median(meta["untraced_ms"])
        print(f"  (c) update_cost_analysis kernel route {got['auto']} vs "
              f"plain route {got['false']} FLOPs; kernel-route step "
              f"{ms:.3f} ms: "
              f"{(got['auto'] or 0) / 1e9 / ms:.3f} TFLOP/s: "
              f"{'ok' if ok_c else 'FAILED'}", flush=True)
    del point, events, ops
    torch.cuda.empty_cache()
    return ok_a and ok_b and ok_c, launches


def profile_path(device):
    """Phase 17.  Returns (ok, launches by path)."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp()
    ok, paths = True, {}
    try:
        for config, dtype_name in PROFILE_POINTS:
            pok, launches = profile_point(device, config, dtype_name, tmp)
            ok &= pok
            paths[f"profile_{config}_{dtype_name}"] = launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 17: {time.perf_counter() - t0:.1f} s", flush=True)
    return ok, paths


BENCH_CONFIGS = ("nerf", "yolo", "train_yolo")
# the phase's budget (90 s) leaves out what the phases above have shown:
# the card's probe and ceilings (it has answered for minutes), and yolo's
# 65,536-ray view (16,384 rays: phase 4's 128x128 view)
BENCH_ENV = {"BENCH_ITERS": "2", "PNY_BENCH_PROBE_TIMEOUT": "0",
             "BENCH_NO_PROBE": "1"}
BENCH_RAYS = {"yolo": "16384"}
BENCH_TIMEOUT = 240  # seconds one config's bench run may take
BENCH_MFU_MAX = 1.05


def bench_path(device):
    """Phase 18: the port's bench, one config a subprocess.  Returns (ok,
    the kernel launches of each config's timed iterations)."""
    import torch

    from pixelnerf_yolo_torch import bench
    from pixelnerf_yolo_torch.ops import field_mlp as fm

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    kind = torch.cuda.get_device_name(device)
    env = {k: v for k, v in bench.child_env(**BENCH_ENV).items()
           if k not in ("BENCH_INNER", "BENCH_DEVICE", "BENCH_RAYS")}
    ok, paths = True, {}
    for cfg in BENCH_CONFIGS:
        t = time.perf_counter()
        rc, out = bench.run_bounded(
            [sys.executable, "-m", "pixelnerf_yolo_torch.bench"],
            BENCH_TIMEOUT,
            dict(env, BENCH_CONFIG=cfg,
                 **({"BENCH_RAYS": BENCH_RAYS[cfg]} if cfg in BENCH_RAYS
                    else {})))
        lines = out.decode(errors="replace").strip().splitlines()
        try:
            rec = json.loads(lines[-1])
        except (IndexError, ValueError):
            rec = {}
        launches = rec.get("kernel_launches", {})
        want = [f"{m}/{fm.variant(m, torch.bfloat16)}"
                for m in bench.KERNELS[cfg]]
        good = (rc == 0 and rec.get("device") == kind
                and rec.get("value", 0) > 0
                and 0 < rec.get("mfu_executed", 0) <= BENCH_MFU_MAX
                and all(launches.get(k, 0) > 0 for k in want))
        print(f"bench {cfg}: rc {rc}, {time.perf_counter() - t:.1f} s, "
              f"kernels wanted {want}: {'ok' if good else 'FAILED'}\n  "
              + "\n  ".join(lines[-3:]), flush=True)
        ok &= good
        paths[f"bench_{cfg}"] = launches
    print(f"phase 18: {time.perf_counter() - t0:.1f} s", flush=True)
    return ok, paths


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
    """Phases 2-18; prints the kernels line; True when every check held."""
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
    # every render above looks its latents up without a gradient: the
    # gather, but for the bf16 YOLO render, whose 32 x 32 table (128-px
    # sources) takes the one-hot form (encoder.py::_lookup: <= 1024 rows)
    renders = {"nerf": (nerf_launches, True), "yolo": (yolo_launches, False),
               "yolo_f32": (yolo32_launches, True),
               "detection": (det_launches, True),
               "viewdirs": (vd_launches, True)}
    wrong = [k for k, (p, want) in renders.items() if bool(p[GATHER]) != want]
    if wrong:
        print(f"FAILED: the latent gather's route on {wrong} (launches "
              f"{ {k: p[GATHER] for k, (p, _) in renders.items()} })")
    ok &= not wrong
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
    # the conv encoder's renders (phase 14 a) at its 128-d latent
    cc1 = r._chunk_rays(CONV_RENDERS[0][2], 1, latent_width=CONV["dL"])
    cc2 = r._chunk_rays(CONV_RENDERS[2][2], 2, latent_width=CONV["dL"])
    conv_rows = {"full_pe": [cc1 * k for k in ks],
                 "pre_combine_pe": [cc2 * k * 2 for k in ks],
                 "post_combine": [cc2 * k for k in ks],
                 "pre_combine": [cc2 * k * 2 for k in ks]}
    del nerf, yolo, viewdirs
    torch.cuda.empty_cache()

    kok, res = check_kernels(device, render_rows, yolo_rows, conv_rows)
    ok &= kok
    gok, gather_res = check_gather(device)
    ok &= gok

    tok, train_launches, _ = train_path(device)
    ok &= tok
    nok, nerf_train_launches, _ = nerf_train_path(device)
    ok &= nok
    t10 = time.perf_counter()
    mok, ms_launches, _ = multiscale_path(device)
    ok &= mok
    t11 = time.perf_counter()
    eok, eval_launches, _ = nerf_eval_path(device)
    ok &= eok
    print(f"phase 10: {t11 - t10:.1f} s; phase 11: "
          f"{time.perf_counter() - t11:.1f} s", flush=True)
    sok, serve_launches, _ = serving_path(device)
    ok &= sok
    iok, interchange_launches = interchange_path(device)
    ok &= iok
    ook, option_launches = options_path(device)
    ok &= ook
    ok &= pointrend_path(device)
    pok, parallel_launches = parallel_path(device)
    ok &= pok
    pok, profile_launches = profile_path(device)
    ok &= pok
    bok, bench_launches = bench_path(device)
    ok &= bok
    paths = {"nerf": nerf_launches, "yolo": yolo_launches,
             "yolo_f32": yolo32_launches, "detection": det_launches,
             "viewdirs": vd_launches,
             "train_step": train_launches["bfloat16"],
             "train_step_f32": train_launches["float32"],
             **nerf_train_launches, **ms_launches, **eval_launches,
             **serve_launches, **interchange_launches, **option_launches,
             **parallel_launches, **profile_launches, **bench_launches}
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
                           ("yolo_f32", "yolo_float32"),
                           ("conv_bfloat16", "dL128_bfloat16"),
                           ("conv_float32", "dL128_float32")):
            if (name, key) in res:
                entry[label] = {k: res[(name, key)][k] for k in timed}
        kernels.append(entry)
    # the gather's launches on the main paths (phase 7's timing left out)
    by_path = {k: p[GATHER] for k, p in paths.items() if GATHER in p}
    kernels.append({"name": "latent_gather", "route": "cuda",
                    "source": "pixelnerf_yolo_torch/csrc/latent_gather.cu",
                    "replaces": None, "launches": sum(by_path.values()),
                    "launches_by_path": by_path,
                    "dtype": "bfloat16", "shapes": gather_res})
    print(json.dumps({"kernels": kernels}))
    return ok


if __name__ == "__main__":
    sys.exit(main())
