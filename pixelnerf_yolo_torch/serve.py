"""Serving export: the render step as a saved ``torch.export`` program.

Counterpart of pixelnerf_yolo_tpu/serve.py.  ``export_render`` traces the
render step (encode the source views, then render the ray batch, NeRF or
YOLO) with ``torch.export.export`` under ``torch.no_grad()`` and saves it
with ``torch.export.save``, so a serving process can load and run it
without building the model.  The field's kernels are custom ops
(``pixelnerf_yolo::<mode>``, ops/field_mlp.py) and stay nodes of the graph;
their stacked weights are computed once, at export, and kept as constants
of the program (``field_mlp.frozen_weights``).  The program runs on the
device it was exported on, at the exported shapes.

An artifact (one file): a magic line, the header's length (8 bytes, big
endian), a JSON header (format, mode, ``want_weights``, device, the
argument layout: name, shape and dtype of each argument), then the saved
program, which holds the model's weights.

The exported signature is ``fn(images, poses, focal, rays, *draws)``: the
port's renderers take injected draws where the JAX package takes a key,
so the draws are arguments (``make_draws``): NeRF ``u_coarse`` and, as the
renderer makes them, ``u``, ``u_jitter``, ``noise_d`` over the padded
batch; YOLO ``u``.

CLI:
  python -m pixelnerf_yolo_torch.serve --conf conf/exp/srn.conf \\
      --checkpoint <dir> --rays 16384 --out model.pnyt
"""

from __future__ import annotations

import io
import json
import os
import sys

import torch
from torch import nn

from .ops import field_mlp  # registers the kernel ops a program calls

_MAGIC = b"PNYTORCHEXPORT\n"
FORMAT = 1


class RenderStep(nn.Module):
    """encode + render as one module: what ``export_render`` traces."""

    def __init__(self, model, renderer, want_weights: bool = False):
        super().__init__()
        from .render import YoloRenderer

        self.model = model
        self.renderer = renderer
        self.want_weights = want_weights
        self.yolo = isinstance(renderer, YoloRenderer)

    def draw_names(self) -> tuple:
        if self.yolo:
            return ("u",)
        return tuple(self.renderer.draw(0, device="cpu"))

    def forward(self, images, poses, focal, rays, *draws):
        cond = self.model.encode(images, poses, focal)
        if self.yolo:
            return self.renderer(self.model, cond, rays, u=draws[0])
        return self.renderer(self.model, cond, rays,
                             draws=dict(zip(self.draw_names(), draws)),
                             want_weights=self.want_weights)


def build_render_fn(conf, model=None, *, want_weights: bool = False,
                    device="cuda"):
    """(fn, model): the serving step of this conf, ``fn(images, poses,
    focal, rays, *draws)``, over ``model`` (a new one from the conf with
    seed-0 weights when None)."""
    from .models import make_model
    from .render import make_renderer

    if model is None:
        model = make_model(conf.get_config("model"), device=device,
                           load_pretrained=False)
    renderer = make_renderer(conf, device=model.device)
    return RenderStep(model, renderer, want_weights=want_weights), model


def make_draws(fn: RenderStep, images, rays, generator=None) -> tuple:
    """The draws a render of ``rays`` (SB, B, 8) takes, in ``fn``'s order:
    NeRF over the batch padded to whole chunks (``NeRFRenderer.draw``),
    YOLO (SB*B, n_coarse) uniforms."""
    sb, n = rays.shape[:2]
    r = fn.renderer
    if fn.yolo:
        return (torch.rand((sb * n, r.n_coarse), generator=generator,
                           device=rays.device),)
    ns = images.shape[1] if images.ndim == 5 else 1
    cb = r._chunk_rays(n, ns, latent_width=fn.model.latent_width(ns))
    d = r.draw(sb * -(-n // cb) * cb, generator, rays.device)
    return tuple(d[k] for k in fn.draw_names())


def _layout(fn: RenderStep, args) -> list:
    names = ("images", "poses", "focal", "rays") + fn.draw_names()
    return [[name, list(a.shape), str(a.dtype).replace("torch.", "")]
            for name, a in zip(names, args)]


def export_render(conf, model, example_args, *,
                  want_weights: bool = False) -> bytes:
    """Trace and save the render step of ``model`` at the shapes and on the
    device of ``example_args`` = (images, poses, focal, rays, *draws),
    tensors (``make_draws`` makes the draws).

    :return the artifact's bytes (header + saved program)
    """
    from .nn.resnetfc import ResnetFC

    fn, model = build_render_fn(conf, model, want_weights=want_weights)
    args = tuple(example_args)
    mlps = [m for m in (model.mlp_coarse, model.mlp_fine)
            if isinstance(m, ResnetFC)]
    with torch.no_grad(), field_mlp.frozen_weights(mlps, model.compute_dtype):
        program = torch.export.export(fn, args, strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    header = json.dumps({
        "format": FORMAT,
        "mode": "yolo" if fn.yolo else "nerf",
        "want_weights": bool(want_weights),
        "device": model.device.type,
        "args": _layout(fn, args),
    }).encode()
    return _MAGIC + len(header).to_bytes(8, "big") + header + buf.getvalue()


def _split_artifact(artifact: bytes):
    if not artifact.startswith(_MAGIC):
        raise ValueError("not a pixelnerf_yolo_torch serving artifact")
    off = len(_MAGIC)
    hlen = int.from_bytes(artifact[off:off + 8], "big")
    header = json.loads(artifact[off + 8:off + 8 + hlen].decode())
    if header.get("format") != FORMAT:
        raise ValueError(f"serving artifact format {header.get('format')!r}, "
                         f"expected {FORMAT}")
    return header, artifact[off + 8 + hlen:]


def load_weights_from_artifact(artifact: bytes) -> dict:
    """The model weights baked into an artifact (the saved program's
    state_dict)."""
    return dict(torch.export.load(
        io.BytesIO(_split_artifact(artifact)[1])).state_dict)


def load_render(artifact: bytes):
    """(call, header): ``call(images, poses, focal, rays, *draws)`` runs the
    saved program on arguments of the exported shapes, dtypes and device
    (it raises ValueError on any other), without autograd."""
    header, blob = _split_artifact(artifact)
    module = torch.export.load(io.BytesIO(blob)).module()

    def call(*args):
        if len(args) != len(header["args"]):
            raise ValueError(f"{len(args)} arguments, the artifact takes "
                             f"{len(header['args'])}")
        for a, (name, shape, dtype) in zip(args, header["args"]):
            if (list(a.shape) != shape or str(a.dtype) != f"torch.{dtype}"
                    or a.device.type != header["device"]):
                raise ValueError(
                    f"{name}: {tuple(a.shape)} {a.dtype} on {a.device}, the "
                    f"artifact takes {tuple(shape)} {dtype} on "
                    f"{header['device']}")
        with torch.no_grad():
            return module(*args)

    return call, header


def _cli(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        description="Export the serving render step as a torch.export "
                    "artifact")
    parser.add_argument("--conf", required=True)
    parser.add_argument("--checkpoint", default=None,
                        help="checkpoint dir (train/checkpoints layout); "
                             "the trained weights are baked into the "
                             "artifact.  Required unless --init-weights")
    parser.add_argument("--init-weights", action="store_true",
                        help="bake a fresh random init instead of a "
                             "checkpoint (graph/shape export, smoke use)")
    parser.add_argument("--rays", type=int, default=16384)
    parser.add_argument("--views", type=int, default=1)
    parser.add_argument("--size", type=int, default=128,
                        help="source image H=W")
    parser.add_argument("--device", default="cuda",
                        help="the device the artifact runs on (cuda or cpu)")
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    if not args.checkpoint and not args.init_weights:
        parser.error("--checkpoint is required (the weights are baked "
                     "into the artifact); pass --init-weights for an "
                     "explicit fresh-init graph export")

    from .config.hocon import parse_file
    from .train.checkpoints import load_weights

    conf = parse_file(args.conf)
    fn, model = build_render_fn(conf, device=args.device)
    if args.checkpoint:
        ck = os.path.normpath(args.checkpoint)
        if not os.path.exists(os.path.join(ck, "pixel_nerf_latest")):
            parser.error(f"no pixel_nerf_latest under {ck!r}: a serving "
                         "export must bake real weights (or pass "
                         "--init-weights)")
        ns = argparse.Namespace(checkpoints_path=os.path.dirname(ck) or ".",
                                name=os.path.basename(ck), resume=True)
        load_weights(ns, model)

    dev = model.device
    NS, H = args.views, args.size
    images = torch.zeros((1, NS, 3, H, H), device=dev)
    poses = torch.eye(4, device=dev).repeat(1, NS, 1, 1)
    focal = torch.tensor(1.2 * H, device=dev)
    rays = torch.zeros((1, args.rays, 8), device=dev)
    draws = make_draws(fn, images, rays, torch.Generator(dev).manual_seed(0))
    blob = export_render(conf, model, (images, poses, focal, rays, *draws))
    with open(args.out, "wb") as f:
        f.write(blob)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"exported {dev.type} artifact: {args.out} ({len(blob)} bytes, "
          f"{args.rays} rays/call, {n_params} params)")


if __name__ == "__main__":
    _cli(sys.argv[1:])
