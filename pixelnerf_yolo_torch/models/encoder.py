"""Spatial (pixel-aligned) and global image encoders, and the latent
lookups.

Counterpart of ``SpatialEncoder``, ``latent_scaling_of``, ``index_latent``,
``ImageEncoder``, ``index_global`` and ``make_encoder`` in
pixelnerf_yolo_tpu/models/encoder.py.  The spatial encoder (ResNet, the
custom ELAN or the conv U-Net) returns backbone features at several scales,
upsampled to the scale-0 size and concatenated into one latent map; with
``feature_scale`` != 1 the images are first resized (area below 1,
bilinear with aligned corners above), while the uv of ``index_latent``
stay in the original images' pixels.  The global encoder returns the
spatial mean of a ResNet's last map, through ``fc`` when its
``latent_size`` is not 512.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..nn.resnet import STAGE_WIDTHS, ResNetFeatures
from ..ops.grid_sample import grid_sample_nhwc, grid_sample_nhwc_q8
from ..ops.resize import resize_area, resize_bilinear
from ..utils.profiling import scope
from .yolo_backbone import YOLO_BACKBONE_LATENT, ConvEncoder, YOLOBackbone


def spatial_latent_size(backbone: str, num_layers: int) -> int:
    if backbone == "custom":
        return YOLO_BACKBONE_LATENT
    if backbone == "conv":
        return 128
    return int(np.cumsum([0] + STAGE_WIDTHS)[num_layers])


class SpatialEncoder(nn.Module):
    """Multi-scale pixel-aligned encoder producing one concatenated latent."""

    def __init__(self, backbone: str = "resnet34", num_layers: int = 4,
                 index_interp: str = "bilinear", index_padding: str = "border",
                 feature_scale: float = 1.0, use_first_pool: bool = True,
                 norm_type: str = "batch",
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.backbone = backbone
        self.num_layers = num_layers
        self.index_interp = index_interp
        self.index_padding = index_padding
        self.feature_scale = feature_scale
        self.cdt = dtype
        if backbone == "custom":
            self.model = YOLOBackbone(generator=generator)
        elif backbone == "conv":
            self.model = ConvEncoder(generator=generator)
        else:
            self.model = ResNetFeatures(backbone, num_layers, use_first_pool,
                                        norm_type, generator=generator)

    @property
    def latent_size(self) -> int:
        return spatial_latent_size(self.backbone, self.num_layers)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """:param x (B, H, W, 3) NHWC, values in [-1, 1]
        :param train BatchNorm on the batch's statistics, updating the
          running ones
        :return latent (B, Hl, Wl, C), f32 unless every map kept its size
        """
        x = x.permute(0, 3, 1, 2)
        if self.feature_scale != 1.0:
            hw = (int(x.shape[2] * self.feature_scale),
                  int(x.shape[3] * self.feature_scale))
            x = (resize_bilinear(x, hw, align_corners=True)
                 if self.feature_scale > 1.0 else resize_area(x, hw))
        with scope("encoder_trunk"):
            latents = self.model(x, self.cdt, train)
        # the reference's "nearest " conf value (trailing space) turns
        # align_corners off for the upsampling; any other value keeps it on
        align = self.index_interp != "nearest "
        tgt = tuple(latents[0].shape[2:4])
        ups = [resize_bilinear(f, tgt, align_corners=align) for f in latents]
        return torch.cat(ups, dim=1).permute(0, 2, 3, 1)

    @classmethod
    def from_conf(cls, conf, dtype: torch.dtype = torch.float32,
                  generator: torch.Generator | None = None):
        """As the JAX package's ``from_conf``, which reads no
        ``norm_type``: a conf builds BatchNorm whatever it sets there."""
        return cls(
            backbone=conf.get_string("backbone"),
            num_layers=conf.get_int("num_layers", 4),
            index_interp=conf.get_string("index_interp", "bilinear"),
            index_padding=conf.get_string("index_padding", "border"),
            feature_scale=conf.get_float("feature_scale", 1.0),
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
                 index_padding: str = "border",
                 scales: torch.Tensor | None = None,
                 nan_scrub_ok: bool = False) -> torch.Tensor:
    """Pixel-aligned feature lookup.

    :param latent_flat (B, Hl*Wl, C), int8 when ``scales`` is given
      (model.latent_int8: ``grid_sample_nhwc_q8``, bf16 out)
    :param uv (B, N, 2) pixel coords (x, y) in image space, or already in
      [-1, 1] when image_size is None
    :param image_size (W, H) of the images the uv are expressed in
    :param nan_scrub_ok the caller zeroes NaN latents anyway (the YOLO
      path), so a small bf16 table may take the one-hot form's rounding
      points (``interp_matmul``), which zero NaN table entries
    :return (B, N, C)
    """
    with scope("encoder_index"):
        if image_size is not None:
            with scope("encoder_index_pre"):
                uv = (uv * (latent_scaling_of(latent_hw, uv.device)
                            / image_size) - 1.0)
        return _lookup(latent_flat, latent_hw, uv, index_interp,
                       index_padding, scales, nan_scrub_ok)


def _lookup(latent_flat, latent_hw, uv, index_interp, index_padding, scales,
            nan_scrub_ok):
    """``index_latent``'s sampling of uv in [-1, 1]."""
    if scales is not None:
        if index_interp.strip() != "bilinear":
            raise NotImplementedError(
                "model.latent_int8 serving mode only implements "
                f"bilinear sampling; conf index_interp={index_interp!r}."
                " Disable latent_int8 or use index_interp=bilinear."
            )
        return grid_sample_nhwc_q8(latent_flat, scales, uv, latent_hw[0],
                                   latent_hw[1], padding_mode=index_padding,
                                   align_corners=True)
    # the JAX package's condition for its one-hot matmul form
    interp_matmul = (nan_scrub_ok
                     and latent_hw[0] * latent_hw[1] <= 1024
                     and latent_flat.dtype == torch.bfloat16
                     and index_interp.strip() == "bilinear")
    return grid_sample_nhwc(
        latent_flat, uv, latent_hw[0], latent_hw[1],
        # "nearest " (trailing space) still samples nearest, align_corners on
        mode=index_interp.strip(),
        padding_mode=index_padding,
        align_corners=True,
        interp_matmul=interp_matmul,
    )


class ImageEncoder(nn.Module):
    """Global image encoder: the spatial mean of a whole ResNet trunk's last
    map (512-d), through ``fc`` when ``latent_size`` != 512.  Always f32
    and BatchNorm, as in the JAX package."""

    def __init__(self, backbone: str = "resnet34", latent_size: int = 128,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.backbone = backbone
        self.latent_size = latent_size
        self.model = ResNetFeatures(backbone, num_layers=5,
                                    use_first_pool=True, generator=generator)
        self.fc = None
        if latent_size != 512:
            # flax Dense's init: lecun normal (untruncated here), zero bias
            self.fc = nn.Linear(512, latent_size)
            with torch.no_grad():
                self.fc.weight.normal_(0.0, 512 ** -0.5, generator=generator)
                self.fc.bias.zero_()

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """:param x (B, H, W, 3) NHWC -> (B, latent_size) f32"""
        feats = self.model(x.permute(0, 3, 1, 2), torch.float32, train)
        v = feats[-1].mean(dim=(2, 3))
        return v if self.fc is None else self.fc(v)

    @classmethod
    def from_conf(cls, conf, generator: torch.Generator | None = None):
        return cls(backbone=conf.get_string("backbone"),
                   latent_size=conf.get_int("latent_size", 128),
                   generator=generator)


def index_global(latent: torch.Tensor, n_points: int) -> torch.Tensor:
    """Broadcast a global latent per point: (B, L) -> (B, n_points, L)."""
    return latent[:, None, :].expand(latent.shape[0], n_points,
                                     latent.shape[1])


def make_encoder(conf, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
    enc_type = conf.get_string("type", "spatial")
    if enc_type == "spatial":
        backbone = conf.get_string("backbone")
        if backbone not in ("resnet18", "resnet34", "custom", "conv"):
            raise NotImplementedError(f"backbone {backbone!r} is not ported")
        return SpatialEncoder.from_conf(conf, dtype=dtype, generator=generator)
    if enc_type == "global":
        return ImageEncoder.from_conf(conf, generator=generator)
    raise NotImplementedError("Unsupported encoder type")
