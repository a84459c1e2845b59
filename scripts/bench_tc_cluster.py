#!/usr/bin/env python3
"""Time the port's tensor-core field-MLP kernel with clusters of 1 and 2.

    python3 scripts/bench_tc_cluster.py      (on a machine with an NVIDIA GPU)

``csrc/field_mlp_tc.cu`` multicasts each weight stage to every CTA of a
cluster, so that one fetch from L2 feeds 64 x kCluster rows.  This script
builds the kernel with ``-DFIELD_MLP_TC_CLUSTER=1`` and ``=2`` (one nvcc
each, started together, into ``pixelnerf_yolo_torch/_build/``), checks
both against the plain twin, and times bf16 ``pre_combine_pe`` at the NeRF
(1,048,576 rows) and YOLO (572,160 rows) widths of ``chip_smoke.py``'s
phase 7, the two builds in turns (2, 1, 1, 2), each time the mean of 20
launches.  The last lines are the card's name and power limit and one
JSON object with the times.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build(fm, cluster: int):
    out = fm.BUILD_DIR / f"libfield_mlp_tc_cluster{cluster}.so"
    fm.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [fm._nvcc(), *fm.NVCC_FLAGS, f"-DFIELD_MLP_TC_CLUSTER={cluster}",
         "-o", str(out), str(fm.SOURCES["field_mlp_tc"])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench_tc_cluster: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from pixelnerf_yolo_torch.nn.code import PositionalEncoding
    from pixelnerf_yolo_torch.ops import field_mlp as fm

    torch.backends.cuda.matmul.allow_tf32 = False
    fm.load_library()
    builds = {c: build(fm, c) for c in (1, 2)}
    libs = {}
    for c, (proc, out) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(log, file=sys.stderr)
            return 1
        libs[c] = fm.bind_tc(out)
        assert libs[c].field_mlp_tc_cluster() == c
    dev, cdt = torch.device("cuda"), torch.bfloat16
    code = PositionalEncoding(6, 3, 1.5, True).to(dev)
    times, ok = {}, True
    for label, spec, rows in (("nerf", cs.NERF, 1_048_576),
                              ("yolo", cs.YOLO, 572_160)):
        w = fm.stack_params(cs.field_mlp_of(spec, cdt, dev), cdt)
        g = torch.Generator(device=dev).manual_seed(1)
        base = (torch.rand((rows, 6), generator=g, device=dev) * 2 - 1)
        lat = torch.randn((rows, spec["dL"]), generator=g,
                          device=dev).to(cdt)
        ref = fm.pre_combine_pe_plain(base, lat, w, code).float()
        tol = cs.KERNEL_TOL["bfloat16"] * max(1.0, ref.abs().max().item())
        for c in (2, 1, 1, 2):
            fm._libraries["field_mlp_tc"] = libs[c]
            err = (fm.pre_combine_pe(base, lat, w, code).float()
                   - ref).abs().max().item()
            ok &= err <= tol
            ms = cs.time_ms(lambda: fm.pre_combine_pe(base, lat, w, code), 20)
            times.setdefault(f"{label}_cluster{c}", []).append(ms)
            print(f"{label} rows={rows} cluster={c}: {ms:.3f} ms "
                  f"max_abs_err={err:.3e} (tol {tol:.3e})", flush=True)
        del ref, base, lat
    print(cs.nvidia_smi())
    print(json.dumps({"ok": bool(ok), "ms": times}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
