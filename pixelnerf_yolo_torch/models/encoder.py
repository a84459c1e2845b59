"""Spatial (pixel-aligned) image encoder and latent lookup.

Counterpart of ``SpatialEncoder``, ``latent_scaling_of``, ``index_latent``
and ``make_encoder`` in pixelnerf_yolo_tpu/models/encoder.py, for the
spatial ResNet and custom ELAN (YOLO) paths: backbone features at several
scales, upsampled to the scale-0 size and concatenated into one latent map.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..nn.resnet import STAGE_WIDTHS, ResNetFeatures
from ..ops.grid_sample import grid_sample_nhwc
from ..ops.resize import resize_bilinear
from .yolo_backbone import YOLO_BACKBONE_LATENT, YOLOBackbone


def spatial_latent_size(backbone: str, num_layers: int) -> int:
    if backbone == "custom":
        return YOLO_BACKBONE_LATENT
    return int(np.cumsum([0] + STAGE_WIDTHS)[num_layers])


class SpatialEncoder(nn.Module):
    """Multi-scale pixel-aligned encoder producing one concatenated latent."""

    def __init__(self, backbone: str = "resnet34", num_layers: int = 4,
                 index_interp: str = "bilinear", index_padding: str = "border",
                 use_first_pool: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.backbone = backbone
        self.num_layers = num_layers
        self.index_interp = index_interp
        self.index_padding = index_padding
        self.cdt = dtype
        if backbone == "custom":
            self.model = YOLOBackbone(generator=generator)
        else:
            self.model = ResNetFeatures(backbone, num_layers, use_first_pool,
                                        generator=generator)

    @property
    def latent_size(self) -> int:
        return spatial_latent_size(self.backbone, self.num_layers)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """:param x (B, H, W, 3) NHWC, values in [-1, 1]
        :param train BatchNorm on the batch's statistics, updating the
          running ones
        :return latent (B, Hl, Wl, C), f32 unless every map kept its size
        """
        latents = self.model(x.permute(0, 3, 1, 2), self.cdt, train)
        # the reference's "nearest " conf value (trailing space) turns
        # align_corners off for the upsampling; any other value keeps it on
        align = self.index_interp != "nearest "
        tgt = tuple(latents[0].shape[2:4])
        ups = [resize_bilinear(f, tgt, align_corners=align) for f in latents]
        return torch.cat(ups, dim=1).permute(0, 2, 3, 1)

    @classmethod
    def from_conf(cls, conf, dtype: torch.dtype = torch.float32,
                  generator: torch.Generator | None = None):
        if conf.get_float("feature_scale", 1.0) != 1.0:
            raise NotImplementedError("encoder.feature_scale != 1 is not ported")
        if conf.get_string("norm_type", "batch") != "batch":
            raise NotImplementedError("only BatchNorm encoders are ported")
        return cls(
            backbone=conf.get_string("backbone"),
            num_layers=conf.get_int("num_layers", 4),
            index_interp=conf.get_string("index_interp", "bilinear"),
            index_padding=conf.get_string("index_padding", "border"),
            use_first_pool=conf.get_bool("use_first_pool", True),
            dtype=dtype,
            generator=generator,
        )


def latent_scaling_of(latent_hw: tuple[int, int], device=None) -> torch.Tensor:
    """latent_scaling = [Wl, Hl] / ([Wl, Hl] - 1) * 2."""
    wl_hl = torch.tensor([latent_hw[1], latent_hw[0]], dtype=torch.float32,
                         device=device)
    return wl_hl / (wl_hl - 1.0) * 2.0


def index_latent(latent_flat: torch.Tensor, latent_hw: tuple[int, int],
                 uv: torch.Tensor, image_size: torch.Tensor | None,
                 index_interp: str = "bilinear",
                 index_padding: str = "border") -> torch.Tensor:
    """Pixel-aligned feature lookup.

    :param latent_flat (B, Hl*Wl, C)
    :param uv (B, N, 2) pixel coords (x, y) in image space, or already in
      [-1, 1] when image_size is None
    :param image_size (W, H) of the images the uv are expressed in
    :return (B, N, C)

    Always the 4-corner gather: the JAX package's one-hot matmul form for
    small bf16 tables on the YOLO path (``nan_scrub_ok``) is not ported
    (ROADMAP.md Queue 1 item 19).
    """
    if image_size is not None:
        uv = uv * (latent_scaling_of(latent_hw, uv.device) / image_size) - 1.0
    return grid_sample_nhwc(
        latent_flat, uv, latent_hw[0], latent_hw[1],
        # "nearest " (trailing space) still samples nearest, align_corners on
        mode=index_interp.strip(),
        padding_mode=index_padding,
        align_corners=True,
    )


def make_encoder(conf, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None) -> SpatialEncoder:
    enc_type = conf.get_string("type", "spatial")
    if enc_type == "spatial":
        backbone = conf.get_string("backbone")
        if backbone == "conv":
            raise NotImplementedError(
                "the conv encoder (backbone = conv) is not ported yet "
                "(ROADMAP.md Queue 1 item 21)"
            )
        if backbone not in ("resnet18", "resnet34", "custom"):
            raise NotImplementedError(f"backbone {backbone!r} is not ported")
        return SpatialEncoder.from_conf(conf, dtype=dtype, generator=generator)
    raise NotImplementedError(f"encoder type {enc_type!r} is not ported")
