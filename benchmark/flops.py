"""The yardstick's arithmetic: the published peaks of the card, the
same-work FLOP and byte counts of the field kernels, and the reference
algorithm's FLOPs of a cell's unit of work.

A field kernel's count is what its part of the ResnetFC needs on its
rows, whatever the kernel does: 2 FLOPs a multiply-add of each Dense
(the PE, activations and bias adds count nothing), each input byte read
once and each output byte written once.  The reference count runs the
benchmark's plain reference under ``FlopCounterMode`` on the meta device,
so that no later change to the program can move it."""

from __future__ import annotations

import torch

# NVIDIA H100 SXM, dense, at the 700 W limit (NVIDIA's data sheet)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def field_widths(conf: dict) -> dict:
    """The ResnetFC's widths from a configuration's ``conf``."""
    m = conf["model"]
    c = m["mlp_coarse"]
    layers = m["encoder"].get("num_layers", 4)
    d_out = c.get("d_out", 4) * (c["num_anchors_per_scale"]
                                 if c.get("yolo") else 1)
    return {"d_in": 3 + 6 * m["code"]["num_freqs"] + 3,
            "d_latent": (1792 if m["encoder"]["backbone"] == "custom"
                         else [0, 64, 128, 256, 512, 1024][layers]),
            "H": c["d_hidden"], "n_pre": min(c["combine_layer"],
                                             c["n_blocks"]),
            "n_post": c["n_blocks"] - min(c["combine_layer"], c["n_blocks"]),
            "d_out": d_out}


def _parts(w):
    H = w["H"]
    pre_mm = w["d_in"] * H + w["n_pre"] * (w["d_latent"] * H + 2 * H * H)
    post_mm = w["n_post"] * 2 * H * H + H * w["d_out"]
    pre_bias = H + w["n_pre"] * 3 * H
    post_bias = w["n_post"] * 2 * H + w["d_out"]
    return pre_mm, post_mm, pre_bias, post_bias


def kernel_work(op: str, rows: int, w: dict, act_bytes: int = 2):
    """(FLOPs, bytes) of one launch of ``op`` (full_pe, pre_combine_pe,
    pre_combine, post_combine) on rows rows; act_bytes the compute
    dtype's size (weights and activations in it, biases, the PE base
    and the field's output in f32)."""
    pre_mm, post_mm, pre_b, post_b = _parts(w)
    H, dL = w["H"], w["d_latent"]
    out_f32 = rows * w["d_out"] * 4
    if op == "full_pe":
        flops = 2 * rows * (pre_mm + post_mm)
        byts = (rows * 6 * 4 + rows * dL * act_bytes
                + (pre_mm + post_mm) * act_bytes + (pre_b + post_b) * 4
                + out_f32)
    elif op in ("pre_combine_pe", "pre_combine"):
        flops = 2 * rows * pre_mm
        base = rows * 6 * 4 if op == "pre_combine_pe" \
            else rows * w["d_in"] * act_bytes
        byts = (base + rows * dL * act_bytes + pre_mm * act_bytes
                + pre_b * 4 + rows * H * act_bytes)
    elif op == "post_combine":
        flops = 2 * rows * post_mm
        byts = (rows * H * act_bytes + post_mm * act_bytes + post_b * 4
                + out_f32)
    else:
        raise KeyError(op)
    return flops, byts


def roofline_seconds(flops: float, byts: float, dtype="bfloat16"):
    """(the least time, "compute" or "memory")."""
    tc, tm = flops / PEAK_FLOPS[dtype], byts / PEAK_BYTES
    return (tc, "compute") if tc >= tm else (tm, "memory")


def reference_flops(conf: dict, images: tuple, rows: int, ns: int,
                    fine_rows: int = 0) -> dict:
    """FLOPs of the reference on the meta device: {"encoder": one
    encode of ``images`` (N, 3, H, W) views, "field": the coarse field on
    ``rows`` (point, view) rows at ``ns`` views plus the fine field on
    ``fine_rows``}."""
    from torch.utils.flop_counter import FlopCounterMode

    from .reference.nets import PixelField

    with torch.device("meta"):
        model = PixelField(conf)
        w = field_widths(conf)
        counter = FlopCounterMode(display=False)
        with counter:
            model.encoder(torch.empty(images))
        enc = counter.get_total_flops()
        counter = FlopCounterMode(display=False)
        with counter:
            model.mlp_coarse(torch.empty(rows, w["d_latent"]),
                             torch.empty(rows, w["d_in"]), ns, rows // ns)
            if fine_rows:
                model.mlp_fine(torch.empty(fine_rows, w["d_latent"]),
                               torch.empty(fine_rows, w["d_in"]), 1,
                               fine_rows)
        field = counter.get_total_flops()
    return {"encoder": float(enc), "field": float(field)}
