#!/usr/bin/env python3
"""The NeRF flagship (f32, plain route, chip_smoke.py's random weights) on
the card against the same model on the CPU, with SPADE and without it:
the latent table, the field at 16 depths of 256 rays (relative to
max|cpu|) and each output of a 1,024-ray render.

    python3 scripts/spade_card_vs_cpu.py

(on a machine with an NVIDIA GPU).  It shows where chip_smoke.py phase 12
(e) compares the field and where the render.
"""
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch

import chip_smoke as cs


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(cs.nvidia_smi())
    for spade in (True, False):
        puts = {"model.mlp_coarse.use_spade": spade,
                "model.mlp_fine.use_spade": spade}
        model, renderer = cs.build_models(dev, puts=puts,
                                          dtypes=("float32",))["float32"]
        model.use_fused_mlp = "false"
        images, poses, focal, rays = cs.flagship_scene(1, 1024, dev)
        draws = renderer.draw(1024, torch.Generator().manual_seed(3), "cpu")
        z = torch.linspace(0.8, 1.8, 16, device=dev)
        pts = (rays[0, :256, None, :3]
               + z[:, None] * rays[0, :256, None, 3:6]).reshape(1, -1, 3)
        vd = rays[0, :256, None, 3:6].expand(256, 16, 3).reshape(1, -1, 3)
        with torch.no_grad():
            cond = model.encode(images, poses, focal)
            field = [model.forward(cond, pts, coarse=c, viewdirs=vd).cpu()
                     for c in (True, False)]
        out = renderer(model, cond, rays, draws=draws)
        cpu = model.to("cpu")
        cpu_r = dataclasses.replace(renderer, device="cpu")
        with torch.no_grad():
            cc = cpu.encode(images, poses, focal)
            ref_field = [cpu.forward(cc, pts.cpu(), coarse=c,
                                     viewdirs=vd.cpu())
                         for c in (True, False)]
        ref = cpu_r(cpu, cc, rays.cpu(), draws=draws)
        table = ((cond.latent_flat.cpu() - cc.latent_flat).abs().max()
                 / cc.latent_flat.abs().max()).item()
        rel = [((a - b).abs().max() / b.abs().max()).item()
               for a, b in zip(field, ref_field)]
        print(f"spade={spade}: table {table:.2e} of max|cpu|; field coarse "
              f"{rel[0]:.2e}, fine {rel[1]:.2e} of max|cpu| "
              f"(coarse max|cpu| {ref_field[0].abs().max().item():.3e})")
        for p in ("coarse", "fine"):
            for k in ("rgb", "depth"):
                d = (out[p][k].cpu() - ref[p][k]).abs()
                print(f"  {p} {k}: max {d.max().item():.3e} p99 "
                      f"{d.flatten().quantile(0.99).item():.3e}, "
                      f"{(d > 1e-4).sum().item()} above 1e-4")
        del model, cpu


if __name__ == "__main__":
    main()
