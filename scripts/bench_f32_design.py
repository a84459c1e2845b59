#!/usr/bin/env python3
"""Time builds of the f32 ring kernel (csrc/field_mlp_f32.cu) with other
tiling constants, in turns.

    python3 scripts/bench_f32_design.py [DESIGN ...] [--reps N]
        [--cases CASE,CASE,...]

(on a machine with an NVIDIA GPU).  A DESIGN is a comma-separated list of
the source's macros without their FIELD_MLP_F32_ prefix, e.g.
``BK=32,STAGES=2`` or ``LOOKAHEAD=1`` or ``CLUSTER=1``, optionally after
another source of the kernel and a colon (``other.cu`` or
``other.cu:CLUSTER=1``: a variant of the source, or the source of another
checkout); ``default`` is the source as it stands (the first design,
always run).
Each design is built with one nvcc, all started together, into
``pixelnerf_yolo_torch/_build/``; its ptxas report at H = 512 is printed,
and it is checked against the plain twin (1e-4 x max|twin|) before it is
timed.  The designs then take turns (in order, then in reverse) timing
each case of ``--cases`` (CASES: an f32 kernel at the widths and rows of
``chip_smoke.py``'s phase 7; ``lin_out`` and ``lin_out_yolo`` are
``post_combine`` with no post block, lin_out alone), each the mean of
``--reps`` launches after a warm-up.  Meanwhile ``nvidia-smi``
samples the SM clock and the power draw every 200 ms; the samples drawn
above 200 W (the kernels running) are summarized.  The last lines are the
card's name and power limit and one JSON object with the times and the
clock.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# case: (kernel, widths in chip_smoke.py, rows, post blocks kept or None)
CASES = {
    "pre_combine_pe": ("pre_combine_pe", "NERF", 1_048_576, None),
    "pre_combine": ("pre_combine", "VIEWDIRS", 1_048_576, None),
    "pre_combine_pe_yolo": ("pre_combine_pe", "YOLO", 572_160, None),
    "full_pe": ("full_pe", "NERF", 1_048_576, None),
    "full_pe_yolo": ("full_pe", "YOLO", 524_288, None),
    "post_combine": ("post_combine", "NERF", 524_288, None),
    "post_combine_yolo": ("post_combine", "YOLO", 190_720, None),
    "lin_out": ("post_combine", "NERF", 524_288, 0),
    "lin_out_yolo": ("post_combine", "YOLO", 190_720, 0),
}


def clocks_under_load(proc) -> dict:
    """Stop an ``nvidia-smi`` sampler; the SM clocks (MHz) of its samples
    above 200 W."""
    proc.terminate()
    out, _ = proc.communicate()
    mhz = []
    for line in out.splitlines():
        try:
            clock, watts = (float(x) for x in line.split(","))
        except ValueError:
            continue
        if watts > 200:
            mhz.append(clock)
    return {"samples": len(mhz), "min_mhz": min(mhz, default=None),
            "max_mhz": max(mhz, default=None)}


def parse(design: str, source) -> tuple:
    """DESIGN -> (source, {macro: value})."""
    if design == "default":
        return source, {}
    if design.split(":")[0].endswith(".cu"):
        source, _, design = design.partition(":")
    return source, dict(kv.split("=") for kv in design.split(",") if kv)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("designs", nargs="*")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--cases", default="pre_combine_pe,pre_combine,"
                    "pre_combine_pe_yolo")
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_f32_design: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from pixelnerf_yolo_torch.nn.code import PositionalEncoding
    from pixelnerf_yolo_torch.ops import field_mlp as fm

    torch.backends.cuda.matmul.allow_tf32 = False
    fm.load_library()
    designs = ["default"] + [d for d in a.designs if d != "default"]
    fm.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, d in enumerate(designs):
        out = fm.BUILD_DIR / f"libfield_mlp_f32_design{i}.so"
        source, macros = parse(d, fm.SOURCES["field_mlp_f32"])
        flags = [f"-DFIELD_MLP_F32_{k}={v}" for k, v in macros.items()]
        procs[d] = (subprocess.Popen(
            [fm._nvcc(), *fm.NVCC_FLAGS, *flags, "-o", str(out),
             str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for d, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"design {d}: nvcc failed\n{log}", file=sys.stderr)
            return 1
        lines = log.splitlines()
        for j, line in enumerate(lines):
            if "Compiling" in line and "ILi512E" in line:
                print(f"design {d}, H=512: "
                      + " | ".join(x.strip() for x in lines[j + 2:j + 4]))
        lib = fm.bind_f32(out)
        consts = (lib.field_mlp_f32_rows_per_cta(),
                  lib.field_mlp_f32_k_step(), lib.field_mlp_f32_stages(),
                  lib.field_mlp_f32_cluster())
        fm.check_f32(lib, consts)
        libs[d] = lib
    dev, cdt = torch.device("cuda"), torch.float32
    g = torch.Generator(device=dev).manual_seed(1)
    code = PositionalEncoding(6, 3, 1.5, True).to(dev)
    code_vd = PositionalEncoding(6, 6, 1.5, True).to(dev)
    times, ok = {}, True
    sampler = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "200"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    for case in a.cases.split(","):
        kind, widths, rows, n_post = CASES[case]
        spec = getattr(cs, widths)
        w = fm.stack_params(cs.field_mlp_of(spec, cdt, dev), cdt)
        if n_post is not None:
            w = dataclasses.replace(w, **{k: getattr(w, k)[:n_post]
                                          .contiguous() for k in
                                          ("w0p", "b0p", "w1p", "b1p")})
        base = torch.rand((rows, 6), generator=g, device=dev) * 2 - 1
        lat = torch.randn((rows, spec["dL"]), generator=g, device=dev)
        if kind == "pre_combine":
            args = (code_vd(base).contiguous(), lat, w)
        elif kind == "post_combine":
            args = (fm.pre_combine_pe_plain(base, lat, w, code).contiguous(),
                    w)
        else:
            args = (base, lat, w, code)
        kernel, plain = getattr(fm, kind), getattr(fm, kind + "_plain")
        ref = plain(*args)
        tol = cs.KERNEL_TOL["float32"] * ref.abs().max().item()
        for d in designs + designs[::-1]:
            fm._libraries["field_mlp_f32"] = libs[d]
            err = (kernel(*args) - ref).abs().max().item()
            ok &= err <= tol
            ms = cs.time_ms(lambda: kernel(*args), a.reps)
            times.setdefault(f"{case}|{d}", []).append(ms)
            print(f"{case} rows={rows} design {d}: {ms:.3f} ms "
                  f"max_abs_err={err:.3e} (tol {tol:.3e})", flush=True)
        del args, ref, base, lat
        torch.cuda.empty_cache()
    clock = clocks_under_load(sampler)
    fm._libraries["field_mlp_f32"] = libs["default"]
    print(f"SM clock above 200 W: {clock}")
    print(cs.nvidia_smi())
    print(json.dumps({"ok": bool(ok), "ms": times, "sm_clock": clock}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
