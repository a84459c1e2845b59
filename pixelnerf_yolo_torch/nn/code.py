"""NeRF positional encoding.

Counterpart of pixelnerf_yolo_tpu/nn/code.py.  Output layout per point is
[x (if include_input), sin(f1 x), cos(f1 x), sin(f2 x), cos(f2 x), ...],
each sin/cos block spanning all d_in dims, with f_i = freq_factor * 2**i
and cos(t) computed as sin(t + pi/2).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..utils.profiling import scope


class PositionalEncoding(nn.Module):
    def __init__(self, num_freqs: int = 6, d_in: int = 3,
                 freq_factor: float = np.pi, include_input: bool = True):
        super().__init__()
        self.num_freqs = num_freqs
        self.d_in = d_in
        self.freq_factor = freq_factor
        self.include_input = include_input
        self.d_out = num_freqs * 2 * d_in + (d_in if include_input else 0)
        freqs = freq_factor * 2.0 ** np.arange(num_freqs, dtype=np.float32)
        phases = np.zeros(2 * num_freqs, dtype=np.float32)
        phases[1::2] = np.pi * 0.5
        # f1 f1 f2 f2 ... with phases 0 pi/2 0 pi/2 ...: sin alternates sin/cos
        self.register_buffer(
            "_freqs", torch.from_numpy(np.repeat(freqs, 2))[None, :, None],
            persistent=False,
        )
        self.register_buffer(
            "_phases", torch.from_numpy(phases)[None, :, None],
            persistent=False,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """:param x (..., d_in) -> (..., d_out)"""
        with scope("positional_enc"):
            return self._encode(x)

    def _encode(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        xf = x.reshape(-1, self.d_in)
        embed = xf[:, None, :] * self._freqs + self._phases  # (N, 2F, d_in)
        embed = torch.sin(embed).reshape(xf.shape[0], -1)
        if self.include_input:
            embed = torch.cat([xf, embed], dim=-1)
        return embed.reshape(*lead, self.d_out)

    @classmethod
    def from_conf(cls, conf, d_in: int = 3) -> "PositionalEncoding":
        return cls(
            conf.get_int("num_freqs", 6),
            d_in,
            conf.get_float("freq_factor", float(np.pi)),
            conf.get_bool("include_input", True),
        )
