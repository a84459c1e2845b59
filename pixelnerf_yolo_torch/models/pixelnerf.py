"""PixelNeRF: image-conditioned radiance (NeRF) or detection (YOLO) field.

Counterpart of pixelnerf_yolo_tpu/models/pixelnerf.py.  ``encode`` returns
a :class:`CondState`; ``forward`` evaluates the field at world points from
it.  Mode quirks kept from the reference:
  * NeRF: world->camera built as [R^T | -R^T t] from camera-to-world
    poses; fy negated; uv = (-x/z, -y/z); rgb = sigmoid, sigma = relu
  * YOLO: the poses are already world->camera extrinsics; focal kept;
    uv = (+x/z, +y/z); latents zeroed where camera z >= 0, then where NaN;
    the raw (SB, B, 7 x anchors) field output

The field MLP runs through the fused kernels of ops/field_mlp.py when
``model.use_fused_mlp`` is auto or true and ``_can_fuse`` holds: with the
positional encoding inside the kernel when ``_pe_fusible`` holds
(``fused_pe_forward``), on precomputed z-features otherwise
(``fused_forward``); through the plain ResnetFC when it does not.  On CPU
tensors the fused routes run the kernels' plain twins.

``encode`` and ``forward`` record autograd graphs unless the caller runs
them under ``torch.no_grad()``, as inference must.  The fused routes go
through the autograd Functions of ops/field_mlp.py (kernel forward,
plain-module backward), which keep nothing when no gradient is wanted.
``encode(train=True)`` runs
BatchNorm on the batch's statistics and updates the running ones;
``stop_encoder_grad`` (``--freeze_enc``) keeps the encoder in eval mode
and detaches its latent.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch
from torch import nn

from ..nn.code import PositionalEncoding
from ..nn.resnetfc import ResnetFC
from ..ops import field_mlp
from ..utils.indexing import repeat_interleave
from .encoder import index_latent, make_encoder

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_mlp(conf, d_in: int, d_latent: int = 0, allow_empty: bool = False,
             dtype: torch.dtype = torch.float32, generator=None):
    mlp_type = conf.get_string("type", "mlp")
    if mlp_type == "resnet":
        return ResnetFC.from_conf(conf, d_in, d_latent=d_latent, dtype=dtype,
                                  generator=generator)
    if mlp_type == "empty" and allow_empty:
        return None
    raise NotImplementedError(f"MLP type {mlp_type!r} is not ported")


@dataclasses.dataclass
class CondState:
    """Everything encode() produces that forward() consumes."""

    latent_flat: torch.Tensor  # (SB*NS, Hl*Wl, C) in the compute dtype
    latent_hw: tuple[int, int]
    poses: torch.Tensor  # (SB*NS, 3, 4) world->camera
    focal: torch.Tensor  # (F, 2), F in {1, SB}
    c: torch.Tensor  # (F, 2)
    image_size: torch.Tensor  # (2,) = (W, H) of the encoder's input images
    num_views_per_obj: int


_UNPORTED = {
    "use_global_encoder": "the global encoder",
    "latent_int8": "model.latent_int8 (ROADMAP.md Queue 1 item 19)",
    "mlp_int8": "model.mlp_int8 (ROADMAP.md Queue 1 item 19)",
    "remat": "model.remat (ROADMAP.md Queue 1 item 17)",
    # the JAX package pre-projects by default in bf16 YOLO mode; the port
    # never does, and refuses only a conf that asks for it by name
    "latent_preproject": "model.latent_preproject (ROADMAP.md Queue 1 item 19)",
}


class PixelNeRF(nn.Module):
    """Config-driven model, NeRF or YOLO mode (``mlp_coarse.yolo``).

    Usage (inference; without ``torch.no_grad()`` both calls record an
    autograd graph and keep the encoder's activations alive):
      model = make_model(conf.get_config("model"), device="cuda")
      with torch.no_grad():
          cond = model.encode(images, poses, focal, c=c)
          out = model.forward(cond, xyz, viewdirs=dirs, coarse=True)
    """

    def __init__(self, conf, generator: torch.Generator | None = None,
                 stop_encoder_grad: bool = False):
        super().__init__()
        for key, what in _UNPORTED.items():
            if conf.get_bool(key, False):
                raise NotImplementedError(f"{what} is not ported yet")
        self.compute_dtype = DTYPES[conf.get_string("compute_dtype", "float32")]
        self.use_encoder = conf.get_bool("use_encoder", True)
        if not self.use_encoder:
            raise NotImplementedError("models without the encoder are not "
                                      "ported yet")
        self.encoder = make_encoder(conf.get_config("encoder"),
                                    dtype=self.compute_dtype,
                                    generator=generator)
        if conf.get_bool("encoder.pretrained", True):
            _no_pretrained_graft(self.encoder.backbone)
        self.stop_encoder_grad = stop_encoder_grad
        self.use_xyz = conf.get_bool("use_xyz", False)
        self.normalize_z = conf.get_bool("normalize_z", True)
        self.use_code = conf.get_bool("use_code", False)
        self.use_code_viewdirs = conf.get_bool("use_code_viewdirs", True)
        self.use_viewdirs = conf.get_bool("use_viewdirs", False)

        d_latent = self.encoder.latent_size
        d_in = 3 if self.use_xyz else 1
        if self.use_viewdirs and self.use_code_viewdirs:
            d_in += 3
        self.code = None
        if self.use_code and d_in > 0:
            self.code = PositionalEncoding.from_conf(conf.get_config("code"),
                                                     d_in=d_in)
            d_in = self.code.d_out
        if self.use_viewdirs and not self.use_code_viewdirs:
            d_in += 3

        self.mlp_coarse = make_mlp(conf.get_config("mlp_coarse"), d_in,
                                   d_latent, dtype=self.compute_dtype,
                                   generator=generator)
        self.mlp_fine = make_mlp(conf.get_config("mlp_fine"), d_in, d_latent,
                                 allow_empty=True, dtype=self.compute_dtype,
                                 generator=generator)
        self.use_fused_mlp = conf.get("use_fused_mlp", "auto")
        self.d_in = d_in
        self.yolo = conf.get_bool("mlp_coarse.yolo", False)
        if self.yolo and conf.get_int("mlp_coarse.num_scales", 1) > 1:
            raise NotImplementedError(
                "multi-scale YOLO (mlp_coarse.num_scales > 1) is not ported "
                "yet (ROADMAP.md Queue 1 item 16)")
        self.d_out = self.mlp_coarse.d_out
        self.d_latent = d_latent

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    # -- encoding ------------------------------------------------------------

    def encode(self, images, poses, focal, c=None,
               train: bool = False) -> CondState:
        """Encode source views into a CondState.

        :param images (NS, 3, H, W) or (SB, NS, 3, H, W), values in [-1, 1]
        :param poses (NS, 4, 4) or (SB, NS, 4, 4): camera-to-world in NeRF
          mode, world-to-camera extrinsics in YOLO mode
        :param focal () or (2,) or (SB, 2)
        :param c None or (2,) or (SB, 2)
        :param train BatchNorm on the batch's statistics, updating the
          running ones (not with stop_encoder_grad, which also detaches the
          latent)
        """
        dev = self.device
        f32 = torch.float32
        images = torch.as_tensor(images, dtype=f32, device=dev)
        poses = torch.as_tensor(poses, dtype=f32, device=dev)
        if images.ndim == 5:
            num_views_per_obj = images.shape[1]
            images = images.reshape((-1,) + tuple(images.shape[2:]))
            poses = poses.reshape(-1, 4, 4)
        else:
            num_views_per_obj = 1

        x = images.permute(0, 2, 3, 1)
        if self.stop_encoder_grad:
            with torch.no_grad():
                latent = self.encoder(x)  # (B, Hl, Wl, C)
        else:
            latent = self.encoder(x, train=train)
        B, Hl, Wl, C = latent.shape
        latent_flat = latent.reshape(B, Hl * Wl, C).to(self.compute_dtype)

        if self.yolo:
            w2c = poses[:, :3, :4]
        else:
            rot = poses[:, :3, :3].transpose(1, 2)  # R^T
            trans = -torch.einsum("bij,bj->bi", rot, poses[:, :3, 3])
            w2c = torch.cat([rot, trans[..., None]], dim=-1)

        image_size = torch.tensor([images.shape[-1], images.shape[-2]],
                                  dtype=f32, device=dev)
        focal = torch.as_tensor(focal, dtype=f32, device=dev)
        if focal.ndim == 0:
            focal = focal[None, None].expand(1, 2)
        elif focal.ndim == 1:
            focal = focal[:, None].expand(focal.shape[0], 2)
        if not self.yolo:
            focal = focal * torch.tensor([1.0, -1.0], dtype=f32, device=dev)

        if c is None:
            c = (image_size * 0.5)[None]
        else:
            c = torch.as_tensor(c, dtype=f32, device=dev)
            if c.ndim == 0:
                c = c[None, None].expand(1, 2)
            elif c.ndim == 1:
                c = c[None] if c.shape[0] == 2 else c[:, None].expand(
                    c.shape[0], 2)
        return CondState(
            latent_flat=latent_flat, latent_hw=(Hl, Wl), poses=w2c,
            focal=focal, c=c, image_size=image_size,
            num_views_per_obj=num_views_per_obj,
        )

    # -- the field -----------------------------------------------------------

    def _can_fuse(self, mlp, ns: int, mode: str = "full_pe") -> bool:
        """Whether the fused kernels apply: the conditions of the JAX
        package's ``_can_fuse``, with the width checks of the kernel that
        starts the route (``mode``) and of post_combine, which may end it,
        in place of the TPU's VMEM budget."""
        enabled = self.use_fused_mlp
        if isinstance(enabled, str):
            enabled = enabled.lower() in ("auto", "true", "1", "yes", "on")
        return bool(
            enabled
            and isinstance(mlp, ResnetFC)
            and mlp.beta == 0
            and mlp.combine_type == "average"
            and mlp.d_latent > 0
            and self.d_in > 0
            and (ns == 1 or mlp.combine_layer < mlp.n_blocks)
            and all(field_mlp.fits(self.d_in, mlp.d_latent, mlp.d_hidden,
                                   self.compute_dtype, m, mlp.d_out)
                    for m in (mode, "post_combine"))
        )

    @staticmethod
    def _first_kernel(mlp, ns: int, pe_fusible: bool) -> str:
        """The kernel that starts the fused route: full_pe (the whole MLP
        in one kernel) at NS=1 with a post-combine block, else
        pre_combine_pe when the PE runs in the kernel, pre_combine when it
        does not (``fused_pe_forward``, ``fused_forward``)."""
        if not pe_fusible:
            return "pre_combine"
        if ns == 1 and mlp.combine_layer < mlp.n_blocks:
            return "full_pe"
        return "pre_combine_pe"

    def _pe_fusible(self) -> bool:
        """Whether the positional encoding can run inside the kernel (xyz
        z-feature, PE without viewdirs in the code, viewdirs appended)."""
        return bool(
            self.use_xyz
            and self.normalize_z
            and self.use_code
            and not self.use_code_viewdirs
            and self.use_viewdirs
            and self.code is not None
            and self.code.include_input
            and self.code.num_freqs > 0
        )

    def _to_camera(self, cond: CondState, xyz: torch.Tensor):
        """(SB, B, 3) world points -> rotated and translated, (SB*NS, B, 3)."""
        xyz_rep = repeat_interleave(xyz, cond.num_views_per_obj)
        xyz_rot = torch.einsum("bij,bkj->bki", cond.poses[:, :3, :3], xyz_rep)
        return xyz_rot, xyz_rot + cond.poses[:, None, :3, 3]

    def project_latent(self, cond: CondState, xyz: torch.Tensor) -> torch.Tensor:
        """Per-point conditioning: project xyz into each source camera and
        sample the pixel-aligned latent.

        :param xyz (SB, B, 3) world points
        :return (SB*NS, B, C) latents (YOLO: zeroed behind z = 0 and NaN)
        """
        NS = cond.num_views_per_obj
        _, xyz_cam = self._to_camera(cond, xyz)
        if self.yolo:
            uv = xyz_cam[:, :, :2] / xyz_cam[:, :, 2:]
            # the latents at camera z >= 0 are zeroed below; their uv is
            # zeroed here too, so that a point on the z = 0 plane (uv +-inf
            # or NaN, bilinear weights NaN) carries no NaN into the latent
            # table's gradient through the zero weights (the forward is the
            # same; the JAX package's gradient is NaN there)
            uv = torch.where((xyz_cam[:, :, 2:] >= 0), torch.zeros_like(uv),
                             uv)
        else:
            uv = -xyz_cam[:, :, :2] / xyz_cam[:, :, 2:]
        focal, cc = cond.focal, cond.c
        if focal.shape[0] > 1:
            focal = repeat_interleave(focal, NS)
        if cc.shape[0] > 1:
            cc = repeat_interleave(cc, NS)
        uv = uv * focal[:, None, :] + cc[:, None, :]
        latent = index_latent(
            cond.latent_flat, cond.latent_hw, uv, cond.image_size,
            index_interp=self.encoder.index_interp,
            index_padding=self.encoder.index_padding,
        )
        if self.yolo:
            zero = torch.zeros((), dtype=latent.dtype, device=latent.device)
            latent = torch.where((xyz_cam[:, :, 2] >= 0)[..., None], zero,
                                 latent)
            latent = torch.where(torch.isnan(latent), zero, latent)
        return latent

    def forward(self, cond: CondState, xyz: torch.Tensor, coarse: bool = True,
                viewdirs: Optional[torch.Tensor] = None,
                latent: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Evaluate the conditioned field at world points.

        :param xyz (SB, B, 3); viewdirs (SB, B, 3) if use_viewdirs
        :param latent optional project_latent(cond, xyz) result
        :return (SB, B, d_out): NeRF [sigmoid rgb, relu sigma]; YOLO raw
        """
        return self._forward_impl(cond, xyz, coarse=coarse,
                                  viewdirs=viewdirs, latent=latent)

    def _forward_impl(self, cond, xyz, coarse=True, viewdirs=None,
                      latent=None):
        SB, B, _ = xyz.shape
        NS = cond.num_views_per_obj
        use_fine = not coarse and self.mlp_fine is not None
        mlp = self.mlp_fine if use_fine else self.mlp_coarse
        pe_fusible = self._pe_fusible()
        fuse = self._can_fuse(mlp, NS, self._first_kernel(mlp, NS,
                                                          pe_fusible))
        fuse_pe = fuse and pe_fusible

        xyz_rot, xyz_cam = self._to_camera(cond, xyz)
        vd = None
        if self.use_viewdirs:
            if viewdirs is None:
                raise ValueError("this model needs viewdirs")
            vd = repeat_interleave(viewdirs.reshape(SB, B, 3), NS)
            vd = torch.einsum("bij,bkj->bki", cond.poses[:, :3, :3], vd)
            vd = vd.reshape(-1, 3)

        if latent is None:
            latent = self.project_latent(cond, xyz)
        latent = latent.reshape(-1, latent.shape[-1])

        if fuse_pe:
            # PE runs inside the kernel: ship only [xyz_rot, viewdirs_rot]
            base = torch.cat([xyz_rot.reshape(-1, 3), vd], dim=1)
            out = field_mlp.fused_field(mlp, latent, base, NS, B,
                                        self.compute_dtype, self.code)
        else:
            if self.use_xyz:
                z_feature = (xyz_rot if self.normalize_z else xyz_cam)
                z_feature = z_feature.reshape(-1, 3)
            else:
                src = xyz_rot if self.normalize_z else xyz_cam
                z_feature = -src[..., 2].reshape(-1, 1)
            if self.use_code and not self.use_code_viewdirs:
                z_feature = self.code(z_feature)
            if self.use_viewdirs:
                z_feature = torch.cat([z_feature, vd], dim=1)
            if self.use_code and self.use_code_viewdirs:
                z_feature = self.code(z_feature)
            if fuse:
                out = field_mlp.fused_field(mlp, latent, z_feature, NS, B,
                                            self.compute_dtype)
            else:
                # concatenated in f32, cast to the compute dtype by the MLP
                mlp_input = torch.cat([latent.float(), z_feature.float()],
                                      dim=-1)
                out = mlp(mlp_input, combine_inner_dims=(NS, B))
        out = out.reshape(-1, B, self.d_out)
        if self.yolo:
            return out
        rgb = torch.sigmoid(out[..., :3])
        sigma = torch.relu(out[..., 3:4])
        return torch.cat([rgb, sigma], dim=-1).reshape(SB, B, -1)


def _no_pretrained_graft(backbone: str) -> None:
    """``encoder.pretrained = True``: the JAX package grafts ported
    torchvision ImageNet weights over a ResNet's random init
    (``PixelNeRF._maybe_load_pretrained``) and warns and keeps the random
    init when the npz is missing, as it is in this repo.  The port has no
    graft yet (ROADMAP.md Queue 1 item 16): it warns and keeps the random
    init."""
    if not backbone.startswith("resnet"):
        print(f"encoder init: random (no pretrained source for backbone "
              f"{backbone!r})")
        return
    warnings.warn("encoder.pretrained = True, but the pretrained backbone "
                  "graft is not ported yet (ROADMAP.md Queue 1 item 16); "
                  "proceeding with RANDOM encoder init")
