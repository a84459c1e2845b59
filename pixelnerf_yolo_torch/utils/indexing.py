"""Batched view-combination helpers.

Counterpart of pixelnerf_yolo_tpu/utils/indexing.py.  Rows of a multi-view
tensor are ordered (sb, v, b): scene, source view, point.
"""

from __future__ import annotations

import torch


def repeat_interleave(x: torch.Tensor, repeats: int, dim: int = 0) -> torch.Tensor:
    """Repeat each entry of ``dim`` ``repeats`` times in place."""
    if repeats == 1:
        return x
    return torch.repeat_interleave(x, repeats, dim=dim)


def combine_interleaved(
    t: torch.Tensor, inner_dims=(1,), agg_type: str = "average"
) -> torch.Tensor:
    """Multi-view reduce: reshape (-1, *inner_dims, ...) and reduce dim 1.

    The reduction is a chain of slice adds in the tensor's own dtype, so a
    bf16 stream rounds after every add as the JAX package's does.
    """
    if len(inner_dims) == 1 and inner_dims[0] == 1:
        return t
    t = t.reshape((-1,) + tuple(inner_dims) + tuple(t.shape[1:]))
    ns = int(t.shape[1])
    if agg_type == "average":
        acc = t[:, 0]
        for i in range(1, ns):
            acc = acc + t[:, i]
        return acc / ns if ns > 1 else acc
    if agg_type == "max":
        acc = t[:, 0]
        for i in range(1, ns):
            acc = torch.maximum(acc, t[:, i])
        return acc
    raise NotImplementedError("Unsupported combine type " + agg_type)
