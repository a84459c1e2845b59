#!/usr/bin/env python3
"""Drive the PyTorch port (pixelnerf_yolo_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when its check fails:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: compile csrc/field_mlp.cu with nvcc (sm_90a);
  3. render: the flagship NeRF render (resnet34, 64 + 16 + 16 samples,
     128x128 source views, random weights from a seed) at NS=1 and NS=2 in
     bf16 and f32, through make_model / make_renderer; the kernel launch
     counters are zeroed before these renders and must move; then the same
     renders with model.use_fused_mlp = false, compared with the kernel's;
  4. kernels: each fused field-MLP kernel against its plain twin on the
     card, at the flagship widths (hidden 512, latent 512, PE 42, combine
     layer 3, 5 blocks), in f32 and bf16, on 40,013 rows (a ragged tail)
     and at the row counts of its launches in the renders of phase 3
     (coarse and fine passes); times of the kernel, the twin and a cuBLAS
     addmm chain at the coarse launch's rows, beside the least time the
     card needs for that work.

The second-to-last line is nvidia-smi's "name, power.limit"; the last is
{"ok": true, "device": {...}}.  Without a CUDA device it exits 1 and prints
no result.
"""

from __future__ import annotations

import json
import os
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
}
SOURCE = "pixelnerf_yolo_torch/csrc/field_mlp.cu"
H, DL, D_IN, CL, NB, D_OUT = 512, 512, 42, 3, 5, 4
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


def flagship_mlp(dtype, device, seed=0):
    """Flagship-width ResnetFC with random weights; fc_1 (zero-init) gets
    small noise so that every block does work."""
    import torch

    from pixelnerf_yolo_torch.nn.resnetfc import ResnetFC

    g = torch.Generator().manual_seed(seed)
    mlp = ResnetFC(D_IN, d_out=D_OUT, n_blocks=NB, d_latent=DL, d_hidden=H,
                   combine_layer=CL, dtype=dtype, generator=g)
    perturb_fc1(mlp, g)
    return mlp.to(device)


def perturb_fc1(module, generator, std=0.01):
    import torch

    with torch.no_grad():
        for name, p in module.named_parameters():
            if ".fc_1." in name:
                p.add_(torch.randn(p.shape, generator=generator).to(p.device)
                       * std)


def field_work(kind: str, rows: int, elt: int, w_bytes: int):
    """(flops, bytes) that a kernel's function needs: multiply-adds of its
    layers; its inputs read once, its outputs written once, its weights."""
    pe = D_IN * H + CL * DL * H + 2 * CL * H * H
    post = 2 * (NB - CL) * H * H + H * D_OUT
    if kind == "full_pe":
        mac, io = pe + post, 6 * 4 + DL * elt + D_OUT * 4
    elif kind == "pre_combine_pe":
        mac, io = pe, 6 * 4 + DL * elt + H * elt
    else:
        mac, io = post, H * elt + D_OUT * 4
    return 2 * mac * rows, io * rows + w_bytes


def bound(kind, rows, dtype_name, elt, w_bytes):
    flops, nbytes = field_work(kind, rows, elt, w_bytes)
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
        base, latent, w, code = args
        cdt = latent.dtype
        x = lin(pe_features(base, code).to(cdt), w.w_in, w.b_in)
        for i in range(w.wz.shape[0]):
            x = x + lin(latent, w.wz[i], w.bz[i])
            net = lin(torch.relu(x), w.w0[i], w.b0[i])
            x = x + lin(torch.relu(net), w.w1[i], w.b1[i])
        if kind == "pre_combine_pe":
            return x
    else:
        x, w = args
    for i in range(w.w0p.shape[0]):
        net = lin(torch.relu(x), w.w0p[i], w.b0p[i])
        x = x + lin(torch.relu(net), w.w1p[i], w.b1p[i])
    return lin(torch.relu(x), w.w_out, w.b_out).float()


def check_kernels(device, render_rows):
    """Phase 4.  render_rows[kind] lists the row counts of that kernel's
    launches in the renders of phase 3 (coarse pass first, where its time
    is taken)."""
    import torch

    from pixelnerf_yolo_torch.nn.code import PositionalEncoding
    from pixelnerf_yolo_torch.ops import field_mlp as fm

    code = PositionalEncoding(6, 3, 1.5, True).to(device)
    results = {}
    ok = True
    for dtype_name in ("bfloat16", "float32"):
        cdt = getattr(torch, dtype_name)
        elt = torch.empty((), dtype=cdt).element_size()
        w = fm.stack_params(flagship_mlp(cdt, device), cdt)
        w_bytes = sum(t.numel() * t.element_size()
                      for t in vars(w).values())
        g = torch.Generator(device=device).manual_seed(1)

        def inputs(kind, rows):
            base = torch.rand((rows, 6), generator=g, device=device) * 2 - 1
            base[:, 3:] /= base[:, 3:].norm(dim=-1, keepdim=True)
            lat = torch.randn((rows, DL), generator=g, device=device).to(cdt)
            base = base.contiguous()
            if kind == "post_combine":
                h = fm.pre_combine_pe_plain(base, lat, w, code).contiguous()
                return (h, w)
            return (base, lat, w, code)

        for kind in ("full_pe", "pre_combine_pe", "post_combine"):
            kernel = getattr(fm, kind)
            plain = getattr(fm, kind + "_plain")
            worst = 0.0
            for i, rows in enumerate([CHECK_ROWS, *render_rows[kind]]):
                args = inputs(kind, rows)
                got = kernel(*args)
                ref = plain(*args)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs().max().item()
                scale = max(1.0, ref.float().abs().max().item())
                tol = KERNEL_TOL[dtype_name] * scale
                passed = bool(torch.isfinite(got).all()) and err <= tol
                ok &= passed
                worst = max(worst, err)
                print(f"kernel {kind:15s} {dtype_name:8s} rows={rows} "
                      f"max_abs_err={err:.3e} tol={tol:.3e} "
                      f"({KERNEL_TOL[dtype_name]} x max|ref| {scale:.3g}) "
                      f"{'ok' if passed else 'FAILED'}", flush=True)
                del got, ref
                if i == 1:  # the coarse launch's rows: timed
                    reps = 3
                    ms = time_ms(lambda: kernel(*args), reps)
                    plain_ms = time_ms(lambda: plain(*args), reps)
                    lib_ms = time_ms(lambda: library_chain(kind, *args), reps)
                    bound_ms, bound_by = bound(kind, rows, dtype_name, elt,
                                               w_bytes)
                    print(f"  timed at rows={rows}: kernel_ms={ms:.3f} "
                          f"plain_ms={plain_ms:.3f} library_ms={lib_ms:.3f} "
                          f"bound_ms={bound_ms:.3f} ({bound_by}) "
                          f"kernel/bound={ms / bound_ms:.1f}x", flush=True)
                    results[(kind, dtype_name)] = {
                        "rows": rows, "ms": ms, "plain_ms": plain_ms,
                        "library_ms": lib_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by,
                    }
                del args
                torch.cuda.empty_cache()
            results[(kind, dtype_name)]["max_abs_err"] = worst
            results[(kind, dtype_name)]["checked_rows"] = [
                CHECK_ROWS, *render_rows[kind]]
    return ok, results


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


def render_models(device):
    """The flagship model per compute dtype, weights from seed 0, each with
    the kernels (use_fused_mlp auto) and without (false)."""
    import torch

    from pixelnerf_yolo_torch.config.flagship import flagship_conf
    from pixelnerf_yolo_torch.models import make_model
    from pixelnerf_yolo_torch.render import make_renderer

    models = {}
    for dtype_name in ("bfloat16", "float32"):
        conf = flagship_conf(compute_dtype=dtype_name)
        model = make_model(conf.get_config("model"), device=device, seed=0)
        perturb_fc1(model, torch.Generator().manual_seed(2))
        # the hidden state of these random weights has a std of ~50 (the
        # layer3 latents, std ~18, feed it); lin_out scaled by 1/20 puts
        # rgb and density in their working range: mean density ~1 per unit
        # depth, so the composite weights are neither ~0 nor one spike
        with torch.no_grad():
            for mlp in (model.mlp_coarse, model.mlp_fine):
                mlp.lin_out.weight.mul_(0.05)
        models[dtype_name] = (model, make_renderer(conf, device=device))
    return models


def render(models, ns, dtype_name, n_rays, device, fused: str):
    import torch

    model, renderer = models[dtype_name]
    model.use_fused_mlp = fused
    images, poses, focal, rays = flagship_scene(ns, n_rays, device)
    cond = model.encode(images, poses, focal)
    g = torch.Generator(device=device).manual_seed(3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = renderer(model, cond, rays, generator=g)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


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
    ok = run(torch.device("cuda"))
    if not ok:
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def run(device) -> bool:
    """Phases 2-4; prints the kernels line; True when every check held."""
    import torch

    from pixelnerf_yolo_torch.ops import field_mlp as fm

    t0 = time.perf_counter()
    fm.load_library()
    print(f"build: {fm.build_info['path']} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in fm.build_info.get("log", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip())

    models = render_models(device)
    # warm up cuDNN and the allocator on a small render, before the counts
    render(models, 1, "bfloat16", 1024, device, "auto")

    # -- the main path: the renders through the kernels ---------------------
    fm.reset_launches()
    kernel_out = {}
    for ns, dtype_name, n_rays in RENDERS:
        out, sec = render(models, ns, dtype_name, n_rays, device, "auto")
        kernel_out[(ns, dtype_name)] = out
        print(f"render NS={ns} {dtype_name:8s} rays={n_rays} kernels: "
              f"{sec:.3f} s, {n_rays / sec:.1f} rays/s", flush=True)
    launches = dict(fm.launches)
    print(f"launches on the main path: {launches}", flush=True)
    ok = launches["full_pe"] > 0 and launches["pre_combine_pe"] > 0 \
        and launches["post_combine"] > 0
    if not ok:
        print("FAILED: a kernel of the path was never launched")

    # row counts of the kernels' launches in the renders above: a chunk of
    # rays times the coarse samples, then times the fine pass's union;
    # full_pe at NS=1, pre_combine_pe (x 2 views) and post_combine at NS=2
    r = models["bfloat16"][1]
    cb1 = r._chunk_rays(RENDERS[0][2], 1)
    cb2 = r._chunk_rays(RENDERS[2][2], 2)
    ks = (r.n_coarse, r.n_coarse + r.n_fine)
    render_rows = {"full_pe": [cb1 * k for k in ks],
                   "pre_combine_pe": [cb2 * k * 2 for k in ks],
                   "post_combine": [cb2 * k for k in ks]}

    # -- the same renders without the kernels, compared ---------------------
    for ns, dtype_name, n_rays in RENDERS:
        plain, sec = render(models, ns, dtype_name, n_rays, device, "false")
        got = kernel_out[(ns, dtype_name)]
        print(f"render NS={ns} {dtype_name:8s} rays={n_rays} plain:   "
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
    del kernel_out
    torch.cuda.empty_cache()

    kok, res = check_kernels(device, render_rows)
    ok &= kok
    kernels = []
    for name in ("full_pe", "pre_combine_pe", "post_combine"):
        b, f = res[(name, "bfloat16")], res[(name, "float32")]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": b["max_abs_err"], "ms": b["ms"],
            "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "library_ms": b["library_ms"],
            "rows": b["rows"], "checked_rows": b["checked_rows"],
            "dtype": "bfloat16",
            "float32": {k: f[k] for k in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms")},
        })
    print(json.dumps({"kernels": kernels}))
    return ok


if __name__ == "__main__":
    sys.exit(main())
