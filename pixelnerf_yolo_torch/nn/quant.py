"""Dynamic W8A8 int8 products for serving (model.mlp_int8).

Counterpart of pixelnerf_yolo_tpu/nn/quant.py.  Symmetric dynamic
quantization: activations per row (scale computed on the fly), weights per
output channel.  The int32 accumulator is exact, so the only error is the
two roundings:

    out = (x_q @ w_q) * s_x * s_w,   x_q = round(x / s_x) in [-127, 127]

``torch._int_mm`` takes the int8 product: on the card cuBLASLt's, whose
shape rules ``int_mm`` meets by padding with zeros (exact).  Serving only:
``round`` has no gradient, so the model turns this off under
``encode(train=True)``.
"""

from __future__ import annotations

import torch

# cuBLASLt's int8 product on the card (torch._int_mm): more than 16 rows,
# K and N multiples of 8 (either layout of the second operand)
_MIN_ROWS = 17
_MULTIPLE = 8


def _scale(amax: torch.Tensor, eps: float) -> torch.Tensor:
    """max(amax, eps) / 127, a true division on every device (torch on the
    card multiplies by the reciprocal of a Python-number divisor, which can
    round differently)."""
    return torch.clamp(amax, min=eps) / amax.new_tensor(127.0)


def quantize_rows(x: torch.Tensor, eps: float = 1e-12):
    """Per-row symmetric int8: (..., K) -> ((..., K) int8, (..., 1) f32)."""
    f = x.float()
    scale = _scale(f.abs().amax(dim=-1, keepdim=True), eps)
    q = torch.clamp(torch.round(f / scale), -127, 127)
    return q.to(torch.int8), scale


def quantize_cols(w: torch.Tensor, eps: float = 1e-12):
    """Per-output-channel symmetric int8: (K, M) -> ((K, M) int8, (1, M))."""
    f = w.float()
    scale = _scale(f.abs().amax(dim=0, keepdim=True), eps)
    q = torch.clamp(torch.round(f / scale), -127, 127)
    return q.to(torch.int8), scale


def _pad(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if t.shape == (rows, cols):
        return t
    out = t.new_zeros((rows, cols))
    out[:t.shape[0], :t.shape[1]] = t
    return out


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact.  On the card the
    operands are zero-padded to the shapes cuBLASLt takes."""
    M, K = a.shape
    N = b.shape[1]
    if a.device.type != "cuda":
        return torch._int_mm(a.contiguous(), b.contiguous())
    mp = max(M, _MIN_ROWS)
    kp = -(-K // _MULTIPLE) * _MULTIPLE
    np_ = -(-N // _MULTIPLE) * _MULTIPLE
    return torch._int_mm(_pad(a, mp, kp).contiguous(),
                         _pad(b, kp, np_).contiguous())[:M, :N]


def dot_w8a8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, M) through the dynamic int8 product; f32 out."""
    xq, sx = quantize_rows(x)
    wq, sw = quantize_cols(w)
    lead = x.shape[:-1]
    acc = int_mm(xq.reshape(-1, x.shape[-1]), wq)
    return (acc.float().reshape(*lead, -1) * sx) * sw
