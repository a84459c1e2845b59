#!/usr/bin/env python3
"""Time the port's field-MLP kernels (and a render) of checkouts in turns.

    python3 scripts/bench_ab.py ROOT [ROOT ...] [--kinds K1,K2] [--reps N]
        [--dtype bfloat16|float32] [--fine] [--render NS[,NS]] [--yolo]

(on a machine with an NVIDIA GPU).  Each ROOT is a checkout of this
repository (e.g. the parent commit unpacked with ``git archive``, then
this tree, in the order parent, change, change, parent).  For each ROOT,
in the order given, a fresh process imports that checkout's
``pixelnerf_yolo_torch`` and ``chip_smoke.py``, builds its kernels into
its own ``_build/``, checks each kernel of ``--kinds`` against its plain
twin and times it at the rows of ``chip_smoke.py``'s phase 7 (the mean
of ``--reps`` launches after a warm-up) in ``--dtype``: NeRF widths, the
YOLO widths for ``pre_combine_pe`` and ``post_combine`` (NS=3 rows) and
``full_pe`` (NS=1 rows) where that checkout's ``fits`` takes them, and
with ``--fine`` also the fine pass's NeRF rows (1.5x).  ``--render NS`` then
times ``chip_smoke.py``'s NeRF flagship render at each NS given through
the kernels, and ``--yolo`` its YOLO render (NS=3, 16,384 rays), each
twice (the first call in the process, then a second).  The last lines are the card's name and power
limit and one JSON object with every time.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# (kind, widths, rows): phase 7's timed rows (the coarse pass's)
CASES = [("full_pe", "NERF", 1_048_576), ("pre_combine_pe", "NERF", 1_048_576),
         ("post_combine", "NERF", 524_288), ("pre_combine", "VIEWDIRS",
                                             1_048_576),
         ("pre_combine_pe", "YOLO", 572_160), ("post_combine", "YOLO",
                                                190_720),
         ("full_pe", "YOLO", 524_288)]


def child(root: str, kinds: list[str], reps: int, dtype: str, fine: bool,
          render_ns: list[int], yolo: bool) -> dict:
    """Time the kernels of one checkout; runs in its own process."""
    import torch

    sys.path.insert(0, os.path.abspath(root))
    import chip_smoke as cs
    from pixelnerf_yolo_torch.nn.code import PositionalEncoding
    from pixelnerf_yolo_torch.ops import field_mlp as fm

    torch.backends.cuda.matmul.allow_tf32 = False
    fm.load_library()
    dev, cdt = torch.device("cuda"), getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(1)
    code = PositionalEncoding(6, 3, 1.5, True).to(dev)
    code_vd = PositionalEncoding(6, 6, 1.5, True).to(dev)
    out = {}
    cases = [(kind, widths, rows) for kind, widths, rows in CASES
             if kind in kinds and fm.fits(
                 getattr(cs, widths)["d_in"], getattr(cs, widths)["dL"],
                 cs.H, cdt, kind, getattr(cs, widths)["d_out"])]
    if fine:
        cases += [(k, wd, rows * 3 // 2) for k, wd, rows in cases
                  if wd != "YOLO"]
    for kind, widths, rows in cases:
        spec = getattr(cs, widths)
        w = fm.stack_params(cs.field_mlp_of(spec, cdt, dev), cdt)
        base = torch.rand((rows, 6), generator=g, device=dev) * 2 - 1
        lat = torch.randn((rows, spec["dL"]), generator=g, device=dev).to(cdt)
        if kind == "post_combine":
            args = (fm.pre_combine_pe_plain(base, lat, w, code).contiguous(),
                    w)
        elif kind == "pre_combine":
            args = (code_vd(base).to(cdt).contiguous(), lat, w)
        else:
            args = (base, lat, w, code)
        kernel, plain = getattr(fm, kind), getattr(fm, kind + "_plain")
        ref = plain(*args).float()
        err = (kernel(*args).float() - ref).abs().max().item()
        tol = cs.KERNEL_TOL[dtype] * max(1.0, ref.abs().max().item())
        if not err <= tol:
            raise RuntimeError(f"{kind} {widths}: error {err} over {tol}")
        ms = cs.time_ms(lambda: kernel(*args), reps)
        out[f"{kind}_{widths.lower()}_{rows}"] = ms
        print(f"{root} {kind} {widths} rows={rows}: {ms:.3f} ms "
              f"({fm.variant(kind, cdt)}, max_abs_err {err:.3e})", flush=True)
        del args, ref, base, lat
        torch.cuda.empty_cache()
    if render_ns:
        models = cs.build_models(dev)
        for ns in render_ns:
            rays = 65536 if ns == 1 else 16384
            for i in range(2):
                _, sec = cs.render(models, ns, dtype, rays, dev, "auto")
                out[f"render_ns{ns}_{i}"] = sec
                print(f"{root} render NeRF NS={ns} {dtype} rays={rays} "
                      f"call {i}: {sec:.3f} s", flush=True)
        del models
    if yolo:
        model, renderer = cs.build_models(dev, out_scale=1.0, yolo=True,
                                          backbone="custom")[dtype]
        rays = cs.YOLO_SIZE * cs.YOLO_SIZE
        for i in range(2):
            sec = cs.yolo_render(model, renderer, rays, dev, "auto")[1]
            out[f"render_yolo_{i}"] = sec
            print(f"{root} render YOLO NS=3 {dtype} rays={rays} call {i}: "
                  f"{sec:.3f} s", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--kinds", default="full_pe,pre_combine_pe,post_combine,"
                    "pre_combine")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--fine", action="store_true")
    ap.add_argument("--render", default="", metavar="NS[,NS]")
    ap.add_argument("--yolo", action="store_true")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    kinds = a.kinds.split(",")
    if a.child:
        render_ns = [int(n) for n in a.render.split(",") if n]
        print("RESULT " + json.dumps(child(a.roots[0], kinds, a.reps,
                                           a.dtype, a.fine, render_ns,
                                           a.yolo)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("bench_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    runs = []
    for root in a.roots:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), root, "--child",
             "--kinds", a.kinds, "--reps", str(a.reps), "--dtype", a.dtype,
             "--render", a.render] + (["--fine"] if a.fine else [])
            + (["--yolo"] if a.yolo else []),
            capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr)
            return 1
        result = next(line for line in proc.stdout.splitlines()
                      if line.startswith("RESULT "))
        runs.append({"root": root, "ms": json.loads(result[7:])})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
