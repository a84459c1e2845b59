"""PixelNeRF: image-conditioned radiance (NeRF) or detection (YOLO) field.

Counterpart of pixelnerf_yolo_tpu/models/pixelnerf.py.  ``encode`` returns
a :class:`CondState`; ``forward`` evaluates the field at world points from
it.  Mode quirks kept from the reference:
  * NeRF: world->camera built as [R^T | -R^T t] from camera-to-world
    poses; fy negated; uv = (-x/z, -y/z); rgb = sigmoid, sigma = relu
  * YOLO: the poses are already world->camera extrinsics; focal kept;
    uv = (+x/z, +y/z); latents zeroed where camera z >= 0, then where NaN;
    the raw (SB, B, 7 x anchors) field output

The field MLP is a ResnetFC (``mlp.type = resnet``) or an ImplicitNet
(``type = mlp``, the default; nn/mlp.py, plain only).  Its input is
``[global latent, spatial latent, z-features]``: the global latent with
``model.use_global_encoder`` (an ``ImageEncoder`` of the source views,
repeated per point), the spatial one unless ``model.use_encoder = false``
(the encoder still runs in ``encode``, as in the JAX package, but the
field neither gathers nor takes it; ``use_xyz`` must be on then).

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

``model.remat`` recomputes the field in the backward instead of keeping
its activations (``torch.utils.checkpoint``, non-reentrant);
``model.remat_policy`` picks what the checkpoint keeps
(``_resolve_remat_policy``)
and ``model.remat_gather`` moves the latent gather inside it.

Serving modes (inference only; ``encode(train=True)`` turns the int8 ones
off): ``model.latent_int8`` quantizes the latent table per channel to int8
(``grid_sample_nhwc_q8`` gathers it, bf16 out); ``model.mlp_int8`` runs the
ResnetFC's hidden layers through the dynamic int8 product (plain route
only); in bf16 with one MLP the latent table is pre-projected through the
lin_z weights at encode time (``model.latent_preproject``, default true)
unless the field takes the kernel route, whose kernels take the raw
latent (``_preprojects``).  In YOLO mode a bf16 table of at most 1024 rows
is gathered at the JAX package's one-hot rounding points
(``index_latent(nan_scrub_ok=True)``).

``encoder.pretrained = True`` grafts torchvision's ImageNet weights over a
ResNet encoder's random init (nn/pretrained.py); without the npz it warns
and keeps the random init, or raises when ``PNY_PRETRAINED_STRICT`` is
set.  The ELAN backbone has no pretrained source.  ``load_pretrained =
False`` skips the graft, for a model whose weights a checkpoint is about
to overwrite.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import warnings
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..nn.code import PositionalEncoding
from ..nn.mlp import ImplicitNet
from ..nn.resnetfc import ResnetFC, block_out_contexts
from ..ops import field_mlp
from ..ops.grid_sample import quantize_rows_int8
from ..utils.indexing import repeat_interleave
from ..utils.profiling import scope
from .encoder import ImageEncoder, index_latent, make_encoder

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _resolve_remat_policy(name: str):
    """model.remat_policy -> the checkpoint's ``context_fn``, or None for
    the default (save nothing, recompute everything).

    "block" keeps the ResnetFC block outputs (``nn.resnetfc.block_out``;
    the fused route has no such point, so there it keeps nothing, as
    "full"); "dots" keeps every matmul output (memory about that of the
    plain backward)."""
    if name in ("", "full"):
        return None
    if name == "block":
        return block_out_contexts
    if name == "dots":
        return _dots_contexts
    raise ValueError(
        f"Unknown model.remat_policy {name!r} (expected '', 'full', "
        "'block' or 'dots')"
    )


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    dots = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default)
    return (CheckpointPolicy.MUST_SAVE if op in dots
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_contexts():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return create_selective_checkpoint_contexts(_save_dots)


def make_mlp(conf, d_in: int, d_latent: int = 0, allow_empty: bool = False,
             dtype: torch.dtype = torch.float32, generator=None):
    mlp_type = conf.get_string("type", "mlp")
    if mlp_type == "mlp":
        return ImplicitNet.from_conf(conf, d_in, d_latent=d_latent,
                                     generator=generator)
    if mlp_type == "resnet":
        return ResnetFC.from_conf(conf, d_in, d_latent=d_latent, dtype=dtype,
                                  generator=generator)
    if mlp_type == "empty" and allow_empty:
        return None
    raise NotImplementedError("Unsupported MLP type")


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
    # model.latent_int8 (inference): latent_flat is int8 and these are its
    # per-channel scales
    latent_scales: Optional[torch.Tensor] = None  # (C,)
    # latent_flat holds the table projected through mlp_coarse's lin_z
    # weights (C = n_lin_z * d_hidden); the biases come after the gather
    latent_projected: bool = False
    # model.mlp_int8 (inference): the field's hidden layers in int8
    mlp_int8: bool = False
    # model.use_global_encoder: the global encoder's (SB*NS, Lg) f32 latent
    global_latent: Optional[torch.Tensor] = None


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
                 stop_encoder_grad: bool = False,
                 load_pretrained: bool = True):
        super().__init__()
        self.compute_dtype = DTYPES[conf.get_string("compute_dtype", "float32")]
        # model.remat: the field runs under a non-reentrant checkpoint in
        # training; remat_policy selects what it keeps ("", "full",
        # "block", "dots"); remat_gather re-gathers the latents inside it
        # and so ignores the renderer's reused ones
        self.remat = conf.get_bool("remat", False)
        self.remat_policy = conf.get_string("remat_policy", "")
        self._remat_context = _resolve_remat_policy(self.remat_policy)
        self.remat_gather = conf.get_bool("remat_gather", False)
        if self.remat_gather and not self.remat:
            raise ValueError(
                "model.remat_gather requires model.remat = true "
                "(it moves the latent gather inside the checkpoint; "
                "there is no checkpoint without remat)"
            )
        self.use_encoder = conf.get_bool("use_encoder", True)
        self.encoder = make_encoder(conf.get_config("encoder"),
                                    dtype=self.compute_dtype,
                                    generator=generator)
        if load_pretrained and conf.get_bool("encoder.pretrained", True):
            _maybe_load_pretrained(self.encoder)
        self.stop_encoder_grad = stop_encoder_grad
        self.use_xyz = conf.get_bool("use_xyz", False)
        if not (self.use_encoder or self.use_xyz):
            raise ValueError("a model without the encoder needs use_xyz")
        self.normalize_z = conf.get_bool("normalize_z", True)
        self.use_code = conf.get_bool("use_code", False)
        self.use_code_viewdirs = conf.get_bool("use_code_viewdirs", True)
        self.use_viewdirs = conf.get_bool("use_viewdirs", False)

        d_latent = self.encoder.latent_size if self.use_encoder else 0
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

        self.global_encoder = None
        if conf.get_bool("use_global_encoder", False):
            self.global_encoder = ImageEncoder.from_conf(
                conf.get_config("global_encoder"), generator=generator)
            if load_pretrained and conf.get_bool(
                    "global_encoder.pretrained", True):
                _maybe_load_pretrained(self.global_encoder, "global_encoder")
            d_latent += self.global_encoder.latent_size

        self.latent_int8 = conf.get_bool("latent_int8", False)
        self.mlp_int8 = conf.get_bool("mlp_int8", False)
        if self.mlp_int8 and not (
                conf.get_string("mlp_coarse.type", "mlp") == "resnet"
                and conf.get_string("mlp_fine.type", "mlp")
                in ("resnet", "empty")):
            raise ValueError(
                "model.mlp_int8 requires ResnetFC MLPs "
                "(mlp_coarse/mlp_fine type 'resnet')"
            )
        self.latent_preproject = conf.get_bool("latent_preproject", True)
        self.mlp_coarse = make_mlp(conf.get_config("mlp_coarse"), d_in,
                                   d_latent, dtype=self.compute_dtype,
                                   generator=generator)
        self.mlp_fine = make_mlp(conf.get_config("mlp_fine"), d_in, d_latent,
                                 allow_empty=True, dtype=self.compute_dtype,
                                 generator=generator)
        self.use_fused_mlp = conf.get("use_fused_mlp", "auto")
        self.d_in = d_in
        # every scale runs the same field; d_out = 7 x anchors per scale
        self.yolo = conf.get_bool("mlp_coarse.yolo", False)
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
          spatial latent; the global encoder's gradient flows either way,
          as in the JAX package); the int8 serving modes off
        """
        with scope("encode"):
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
            latent_scales = None
            if self.latent_int8 and not train:
                latent_flat, latent_scales = quantize_rows_int8(latent_flat)
            latent_projected = self._preprojects(num_views_per_obj)
            if latent_projected:
                # bilinear interpolation commutes with the lin_z product: the
                # table is projected once (the lin_z weights still get their
                # gradient through it; a frozen encoder's table is detached)
                mlp = self.mlp_coarse
                w_cat = torch.cat([m.weight for m in mlp.lin_z])
                lat = latent_flat.detach() if self.stop_encoder_grad \
                    else latent_flat
                latent_flat = F.linear(lat, w_cat.to(self.compute_dtype))

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
                focal = focal * torch.tensor([1.0, -1.0], dtype=f32,
                                             device=dev)

            if c is None:
                c = (image_size * 0.5)[None]
            else:
                c = torch.as_tensor(c, dtype=f32, device=dev)
                if c.ndim == 0:
                    c = c[None, None].expand(1, 2)
                elif c.ndim == 1:
                    c = c[None] if c.shape[0] == 2 else c[:, None].expand(
                        c.shape[0], 2)
            global_latent = None
            if self.global_encoder is not None:
                global_latent = self.global_encoder(
                    x, train=train and not self.stop_encoder_grad)
            return CondState(
                latent_flat=latent_flat, latent_hw=(Hl, Wl), poses=w2c,
                focal=focal, c=c, image_size=image_size,
                num_views_per_obj=num_views_per_obj,
                latent_scales=latent_scales,
                latent_projected=latent_projected,
                mlp_int8=self.mlp_int8 and not train,
                global_latent=global_latent,
            )

    def _preprojects(self, ns: int) -> bool:
        """Whether encode pre-projects the latent table through
        mlp_coarse's lin_z weights: the JAX package's rule (bf16, one
        ResnetFC MLP with a latent and a block before the combine, no SPADE,
        no int8 table, the spatial encoder and no global one,
        ``model.latent_preproject``), with its clause
        "``use_fused_mlp`` not true" read as "the field does not take the
        kernel route at this NS": the kernels take the raw latent."""
        mlp = self.mlp_coarse
        return bool(
            self.compute_dtype == torch.bfloat16
            and self.mlp_fine is None
            and isinstance(mlp, ResnetFC)
            and mlp.d_latent > 0
            and mlp.n_lin_z > 0
            and not mlp.use_spade
            and not self.latent_int8
            and self.use_encoder
            and self.global_encoder is None
            and self.latent_preproject
            and not self._fuses(mlp, ns)
        )

    def latent_width(self, ns: int) -> int:
        """The width of ``encode``'s latent table at ns source views."""
        if self._preprojects(ns):
            return self.mlp_coarse.n_lin_z * self.mlp_coarse.d_hidden
        return self.d_latent

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
            and not mlp.use_spade
            and mlp.combine_type == "average"
            and mlp.d_latent > 0
            and self.use_encoder
            and self.d_in > 0
            and self.global_encoder is None
            and (ns == 1 or mlp.combine_layer < mlp.n_blocks)
            and all(field_mlp.fits(self.d_in, mlp.d_latent, mlp.d_hidden,
                                   self.compute_dtype, m, mlp.d_out)
                    for m in (mode, "post_combine"))
        )

    def _fuses(self, mlp, ns: int) -> bool:
        """Whether the field of ``mlp`` takes the kernel route at ns source
        views: ``_can_fuse`` for the route's first kernel, and no
        ``model.mlp_int8`` (the kernels have no int8 path)."""
        return (not self.mlp_int8 and isinstance(mlp, ResnetFC)
                and self._can_fuse(mlp, ns, self._first_kernel(
                    mlp, ns, self._pe_fusible())))

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

    def project_latent(self, cond: CondState,
                       xyz: torch.Tensor) -> Optional[torch.Tensor]:
        """Per-point conditioning: project xyz into each source camera and
        sample the pixel-aligned latent.

        :param xyz (SB, B, 3) world points
        :return (SB*NS, B, C) latents (YOLO: zeroed behind z = 0 and NaN;
          C = n_lin_z * d_hidden when the table is pre-projected, and the
          zeroed rows then get exactly the lin_z biases, as zeroed latents
          do; bf16 from an int8 table), or None without the encoder
        """
        if not self.use_encoder:
            return None
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
            scales=cond.latent_scales,
            # YOLO zeroes NaN latents below, so the one-hot form's zeroing
            # of NaN table entries is admissible there (and only there)
            nan_scrub_ok=self.yolo,
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
        :param latent optional project_latent(cond, xyz) result (ignored
          under remat_gather)
        :return (SB, B, d_out): NeRF [sigmoid rgb, relu sigma]; YOLO raw

        With model.remat and autograd on, the field runs under a
        non-reentrant checkpoint: the backward replays it (kernel launches
        included) instead of keeping its activations.
        """
        with scope("model_inference"):
            if not (self.remat and torch.is_grad_enabled()):
                return self._forward_impl(cond, xyz, coarse=coarse,
                                          viewdirs=viewdirs, latent=latent)
            if self.remat_gather:
                latent = None
            kwargs = {}
            if self._remat_context is not None:
                kwargs["context_fn"] = self._remat_context
            return checkpoint(
                functools.partial(self._forward_impl, coarse=coarse),
                cond, xyz, viewdirs=viewdirs, latent=latent,
                use_reentrant=False, **kwargs)

    def _forward_impl(self, cond, xyz, coarse=True, viewdirs=None,
                      latent=None):
        SB, B, _ = xyz.shape
        NS = cond.num_views_per_obj
        use_fine = not coarse and self.mlp_fine is not None
        mlp = self.mlp_fine if use_fine else self.mlp_coarse
        # the kernels take the raw latent, never a pre-projected table
        fuse = not cond.latent_projected and self._fuses(mlp, NS)
        fuse_pe = fuse and self._pe_fusible()

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
        if latent is not None:
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
                # [global, spatial latent, z] concatenated in f32, cast to
                # the compute dtype by a ResnetFC
                parts = [z_feature.float()]
                if latent is not None:
                    parts.insert(0, latent.float())
                if cond.global_latent is not None:
                    rows = parts[0].shape[0] // cond.global_latent.shape[0]
                    parts.insert(0, repeat_interleave(
                        cond.global_latent.float(), rows))
                mlp_input = torch.cat(parts, dim=-1)
                if isinstance(mlp, ImplicitNet):
                    out = mlp(mlp_input, combine_inner_dims=(NS, B))
                else:
                    out = mlp(mlp_input, combine_inner_dims=(NS, B),
                              latent_projected=cond.latent_projected,
                              int8=cond.mlp_int8)
        out = out.reshape(-1, B, self.d_out)
        if self.yolo:
            return out
        rgb = torch.sigmoid(out[..., :3])
        sigma = torch.relu(out[..., 3:4])
        return torch.cat([rgb, sigma], dim=-1).reshape(SB, B, -1)


def _maybe_load_pretrained(encoder, key: str = "encoder") -> None:
    """Graft torchvision's ImageNet weights over a ResNet encoder's random
    init (JAX ``PixelNeRF._maybe_load_pretrained``).  A missing npz warns
    and keeps the random init, or raises under PNY_PRETRAINED_STRICT; the
    ELAN backbone is skipped."""
    from ..nn.pretrained import graft, load_pretrained_backbone

    backbone = encoder.backbone
    if not backbone.startswith("resnet"):
        print(f"{key} init: random (no pretrained source for backbone "
              f"{backbone!r}; the reference's external yolov7.pt has no "
              "correspondence to the built-in ELAN backbone)")
        return
    try:
        state_dict, path = load_pretrained_backbone(backbone)
    except FileNotFoundError as e:
        if os.environ.get("PNY_PRETRAINED_STRICT"):
            raise
        warnings.warn(
            f"{e}\nProceeding with RANDOM encoder init "
            "(encoder.pretrained=True requested; run "
            "scripts/port_torchvision.py to ship the npz, or set "
            "PNY_PRETRAINED_STRICT=1 to make this an error).")
        print(f"{key} init: random (pretrained weights not found)")
        return
    n = graft(encoder.model, state_dict)
    print(f"{key} init: ported torchvision ImageNet {backbone} from {path} "
          f"({n} tensors)")
