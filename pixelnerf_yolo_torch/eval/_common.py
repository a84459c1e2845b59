"""What the evaluation CLIs share: the --device flag, the trained model
and the chunked, ray-sharded NeRF render.

Each CLI's ``main`` starts one rank a ``--gpu_id`` id (``parallel.launch``)
and runs its ``run(args, conf)`` on every rank: the renders shard their
rays over the ranks (``render_rays``), every rank gets the whole result, and
only rank 0 prints and writes files."""

from __future__ import annotations

import numpy as np
import torch

from .. import parallel
from ..models import make_model
from ..parallel.render import RenderParallel
from ..train import checkpoints


def add_device_arg(parser):
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to evaluate on (cuda or cpu)")
    return parser


def load_model(args, conf, device):
    """The conf's model on ``device`` with the trained weights of
    checkpoints/<name>/pixel_nerf_latest (args.resume is set)."""
    args.resume = True
    model = make_model(conf.get_config("model"), device=device,
                       load_pretrained=False)
    checkpoints.load_weights(args, model)
    return model


def render_rays(renderer, model, cond, all_rays: np.ndarray,
                ray_batch_size: int, generator=None):
    """Render (N, 8) rays of one scene in chunks of ray_batch_size, one
    render call and one set of draws each, its rays sharded over the ranks
    when there are several (``parallel.default_mesh``).

    :return (rgb (N, 3), depth (N,)) numpy, of the fine pass when there is
      one, else of the coarse
    """
    branch = "fine" if renderer.using_fine else "coarse"
    render = RenderParallel(renderer, model, mesh=parallel.default_mesh())
    rgb, depth = [], []
    for start in range(0, all_rays.shape[0], ray_batch_size):
        rays = torch.from_numpy(np.ascontiguousarray(
            all_rays[start:start + ray_batch_size], dtype=np.float32))
        out = render(cond, rays[None], generator=generator)[branch]
        rgb.append(out["rgb"][0])
        depth.append(out["depth"][0])
    return (torch.cat(rgb).float().cpu().numpy(),
            torch.cat(depth).float().cpu().numpy())


def read_floats(prompts) -> list | None:
    """One float a prompt, read from stdin by rank 0 and handed to every
    rank; None (on every rank) at the end of input or on a non-number."""
    values = None
    if parallel.is_main():
        try:
            values = [float(input(p)) for p in prompts]
        except EOFError:
            pass
        except ValueError:
            print("non-numeric input, exiting")
    if parallel.world_size() > 1:
        import torch.distributed as dist

        box = [values]
        dist.broadcast_object_list(box, src=0)
        values = box[0]
    return values


def write_video(path: str, frames_u8: np.ndarray, fps: int) -> str:
    """An mp4 at path, or a GIF beside it where imageio has no mp4 writer;
    returns the path written."""
    import imageio

    try:
        imageio.mimwrite(path, frames_u8, fps=fps, quality=8)
    except (ValueError, ImportError):
        path = path[:-4] + ".gif"
        imageio.mimwrite(path, frames_u8, fps=fps)
    return path
