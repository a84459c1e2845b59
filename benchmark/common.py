"""What the drivers share: seeds, the scene generator (cameras, rays,
images, boxes), the program's model built on the device with the
benchmark's weights, and the reference's."""

from __future__ import annotations

import math

import numpy as np
import torch

from . import weights as W
from .reference import nets


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for (seed, keys): the same inputs, the same seed."""
    return int(np.random.SeedSequence([int(seed) % (1 << 64), *keys])
               .generate_state(2, np.uint64)[0] >> np.uint64(1))


def generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


# -- cameras and rays -------------------------------------------------------


def look_at(origin, target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)):
    """Camera-to-world (the camera looks down its -z) at origin."""
    origin, target, up = (np.asarray(v, np.float64)
                          for v in (origin, target, up))
    back = origin - target
    back /= np.linalg.norm(back)
    right = np.cross(up, back)
    right /= np.linalg.norm(right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = right, np.cross(back, right), back
    c2w[:3, 3] = origin
    return c2w.astype(np.float32)


def sphere_views(n: int, radius: float, rng) -> np.ndarray:
    """n camera-to-world poses on a spiral over the upper hemisphere (the
    SRN test trajectory's shape), turned about the up axis by a draw."""
    turn = rng.uniform(0, 2 * np.pi)
    out = []
    for i in range(n):
        t = (i + 0.5) / n
        elev = np.arcsin(0.05 + 0.9 * t)
        azim = turn + i * np.pi * (3 - np.sqrt(5))
        d = [np.cos(elev) * np.sin(azim), np.sin(elev),
             np.cos(elev) * np.cos(azim)]
        out.append(look_at(radius * np.asarray(d)))
    return np.stack(out)


def ring_extrinsics(n: int, radius: float, height: float, rng) -> np.ndarray:
    """n world-to-camera extrinsics evenly spaced on a ring (turned and
    jittered by draws) looking at the origin, with the X row negated as
    the YOLO data loader does."""
    out = []
    angles = (rng.uniform(0, 2 * np.pi) + 2 * np.pi * np.arange(n) / n
              + rng.uniform(-0.1, 0.1, n))
    for a in angles:
        w2c = np.linalg.inv(look_at([radius * np.sin(a), height,
                                     radius * np.cos(a)]))
        w2c[0] *= -1
        out.append(w2c)
    return np.stack(out).astype(np.float32)


def rays_nerf(c2w: torch.Tensor, size: int, focal: float, near: float,
              far: float) -> torch.Tensor:
    """(size * size, 8) rays [origin, unit direction, near, far] of a
    square view; pixel (x, y) looks along ((x - c) / f, -(y - c) / f, -1)
    in the camera frame."""
    dev = c2w.device
    g = (torch.arange(size, dtype=torch.float32, device=dev)
         - size * 0.5) / focal
    Y, X = torch.meshgrid(g, g, indexing="ij")
    d = torch.stack([X, -Y, -torch.ones_like(X)], -1)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    d = torch.einsum("ij,hwj->hwi", c2w[:3, :3], d).reshape(-1, 3)
    o = c2w[:3, 3].expand_as(d)
    nf = torch.tensor([near, far], device=dev).expand(d.shape[0], 2)
    return torch.cat([o, d, nf], -1)


def object_images(gen, n: int, size: int, device) -> torch.Tensor:
    """(n, 3, size, size) in [-1, 1]: a textured ellipse (seeded centre,
    axes and 8-pixel texture) on a white background."""
    u = torch.rand((n, 4), generator=gen, device=device)
    tex = torch.rand((n, 3, size // 8, size // 8), generator=gen,
                     device=device) * 2 - 1
    tex = torch.nn.functional.interpolate(tex, scale_factor=8.0,
                                          mode="nearest")
    g = torch.arange(size, dtype=torch.float32, device=device) / size
    Y, X = torch.meshgrid(g, g, indexing="ij")
    cx, cy = 0.35 + 0.3 * u[:, 0], 0.35 + 0.3 * u[:, 1]
    ax, ay = 0.2 + 0.15 * u[:, 2], 0.15 + 0.15 * u[:, 3]
    inside = (((X - cx[:, None, None]) / ax[:, None, None]) ** 2
              + ((Y - cy[:, None, None]) / ay[:, None, None]) ** 2) <= 1
    return torch.where(inside[:, None], tex, torch.ones_like(tex))


# -- models -----------------------------------------------------------------


def reference_model(cfg: dict, device, meta: bool = False):
    with torch.device("meta" if meta else device):
        return nets.PixelField(cfg["conf"])


def benchmark_weights(cfg: dict, seed: int, device) -> dict:
    specs = W.specs_of(reference_model(cfg, device, meta=True))
    return W.make_weights(specs, cfg["init"], sub_seed(seed, 1), device)


def program_model(cfg: dict, weights: dict, device, conf=None):
    """The program's PixelNeRF built on the device, its parameters the
    benchmark's weights."""
    from pixelnerf_yolo_torch.config.hocon import Config
    from pixelnerf_yolo_torch.models import PixelNeRF

    conf = conf or Config(cfg["conf"])
    with torch.device(device):
        model = PixelNeRF(conf.get_config("model"),
                          generator=torch.Generator(device=device),
                          load_pretrained=False)
    model = model.to(device).eval()
    W.load_into(model, weights)
    return model


def reference_for(cfg: dict, seed: int, device, lowp=None):
    """The reference with the benchmark's weights, float32 (its products'
    operands rounded to lowp, if given), TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = reference_model(cfg, device)
    W.load_into(ref, benchmark_weights(cfg, seed, device))
    nets.set_lowp(ref, lowp)
    return ref.eval()


def release() -> None:
    """Collect what the caller dropped and return its memory to the
    device."""
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def pick(n_done: int, k: int, seed: int) -> list:
    """k of the n_done units, drawn from the seed, always with the last."""
    rng = np.random.default_rng(sub_seed(seed, 99))
    k = min(k, n_done)
    rest = rng.choice(n_done - 1, k - 1, replace=False) if k > 1 else []
    return sorted({n_done - 1, *map(int, rest)})


def rel_gap(a: float, b: float, floor: float) -> float:
    return abs(a - b) / max(abs(b), floor)


def finite(x) -> float:
    x = float(x)
    return x if math.isfinite(x) else float("inf")
