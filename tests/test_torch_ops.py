"""PyTorch port vs the JAX package: config, geometry, PE, resize, grid
sampling, samplers and compositing, on the same numpy inputs (CPU)."""

import glob
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pixelnerf_yolo_tpu.config import hocon as jhocon
from pixelnerf_yolo_tpu.nn.code import PositionalEncoding as JPE
from pixelnerf_yolo_tpu.ops import composite as jcomp
from pixelnerf_yolo_tpu.ops import grid_sample as jgs
from pixelnerf_yolo_tpu.ops import ray_sampling as jrs
from pixelnerf_yolo_tpu.ops.resize import resize_bilinear as jresize
from pixelnerf_yolo_tpu.utils import camera as jcam
from pixelnerf_yolo_tpu.utils import indexing as jidx
from pixelnerf_yolo_torch.config import hocon as thocon
from pixelnerf_yolo_torch.nn.code import PositionalEncoding as TPE
from pixelnerf_yolo_torch.ops import composite as tcomp
from pixelnerf_yolo_torch.ops import grid_sample as tgs
from pixelnerf_yolo_torch.ops import ray_sampling as trs
from pixelnerf_yolo_torch.ops.resize import resize_bilinear as tresize
from pixelnerf_yolo_torch.utils import camera as tcam
from pixelnerf_yolo_torch.utils import indexing as tidx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFS = sorted(glob.glob(os.path.join(REPO, "conf", "**", "*.conf"),
                         recursive=True))


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("path", CONFS, ids=os.path.basename)
def test_config_parse_matches(path):
    assert thocon.parse_file(path).to_dict() == jhocon.parse_file(path).to_dict()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flagship_string_parses_the_same(monkeypatch, dtype):
    from __graft_entry__ import _flagship

    texts = []
    real = jhocon.parse_string

    def capture(text, *a, **k):
        texts.append(text)
        return real(text, *a, **k)

    monkeypatch.setattr(jhocon, "parse_string", capture)
    ref = _flagship(compute_dtype=dtype)
    assert len(texts) == 1
    got = thocon.parse_string(texts[0])
    assert got.to_dict() == ref.to_dict()
    assert got.get_int("model.mlp_coarse.d_hidden") == 512


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d_hidden,backbone,num_layers",
                         [(512, "resnet34", 4), (64, "resnet18", 2)])
def test_port_flagship_conf_matches(dtype, d_hidden, backbone, num_layers):
    from __graft_entry__ import _flagship
    from pixelnerf_yolo_torch.config.flagship import flagship_conf

    args = dict(d_hidden=d_hidden, backbone=backbone, num_layers=num_layers,
                compute_dtype=dtype)
    assert flagship_conf(**args).to_dict() == _flagship(**args).to_dict()


@pytest.mark.parametrize("padding", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_grid_sample_nhwc(rng, padding, align, mode):
    B, H, W, C, N = 2, 5, 7, 3, 96
    flat = rng.normal(size=(B, H * W, C)).astype(np.float32)
    grid = (rng.random((B, N, 2)).astype(np.float32) * 4.0) - 2.0
    # non-finite coordinates follow torch's clip rules
    grid[0, :6] = [[np.nan, 0.1], [np.inf, 0.2], [-np.inf, -0.3],
                   [0.2, np.nan], [0.3, np.inf], [0.1, -np.inf]]
    # op by op: under jit XLA:CPU fuses the corner sum and moved one value
    # of 1.26 by 2.4e-6 (20 ulp) off both the port and the unfused function
    with jax.disable_jit():
        ref = np.asarray(jgs.grid_sample_nhwc(
            flat, grid, H, W, mode=mode, padding_mode=padding,
            align_corners=align))
    got = tgs.grid_sample_nhwc(t(flat), t(grid), H, W, mode=mode,
                               padding_mode=padding,
                               align_corners=align).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-6)
    assert np.array_equal(np.isnan(got), np.isnan(ref))


def test_grid_sample_nhwc_bf16(rng):
    B, H, W, C, N = 1, 6, 6, 8, 64
    flat = rng.normal(size=(B, H * W, C)).astype(np.float32)
    grid = (rng.random((B, N, 2)).astype(np.float32) * 2.2) - 1.1
    ref = np.asarray(jgs.grid_sample_nhwc(
        jnp.asarray(flat, jnp.bfloat16), grid, H, W, padding_mode="zeros",
        align_corners=True).astype(jnp.float32))
    got = tgs.grid_sample_nhwc(t(flat).bfloat16(), t(grid), H, W,
                               padding_mode="zeros",
                               align_corners=True).float().numpy()
    # bf16 corner products and sums: a few bf16 ulps of |values| <= ~4
    np.testing.assert_allclose(got, ref, atol=3e-2)


@pytest.mark.parametrize("align", [True, False])
def test_resize_bilinear(rng, align):
    x = rng.normal(size=(2, 3, 5, 7)).astype(np.float32)
    ref = np.asarray(jresize(jnp.asarray(x), (11, 9), align_corners=align))
    got = tresize(t(x), (11, 9), align_corners=align).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-6)


def test_positional_encoding(rng):
    x = rng.normal(size=(4, 5, 3)).astype(np.float32)
    jpe, tpe = JPE(6, 3, 1.5, True), TPE(6, 3, 1.5, True)
    assert jpe.d_out == tpe.d_out == 39
    np.testing.assert_allclose(tpe(t(x)).numpy(), np.asarray(jpe(x)),
                               atol=2e-6)


@pytest.mark.parametrize("ns", [1, 3])
def test_indexing(rng, ns):
    x = rng.normal(size=(2 * ns * 4, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        tidx.repeat_interleave(t(x), ns).numpy(),
        np.asarray(jidx.repeat_interleave(jnp.asarray(x), ns)))
    for agg in ("average", "max"):
        np.testing.assert_allclose(
            tidx.combine_interleaved(t(x), (ns, 4), agg).numpy(),
            np.asarray(jidx.combine_interleaved(jnp.asarray(x), (ns, 4), agg)),
            atol=1e-6)


def test_gen_rays(rng):
    poses = np.stack([np.eye(4, dtype=np.float32)] * 2)
    poses[1, :3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    poses[:, :3, 3] = rng.normal(size=(2, 3))
    ref = np.asarray(jcam.gen_rays(jnp.asarray(poses), 6, 4,
                                   jnp.float32(5.0), 0.8, 1.8))
    got = tcam.gen_rays(t(poses), 6, 4, torch.tensor(5.0), 0.8, 1.8).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


def _rays(rng, B):
    rays = np.zeros((B, 8), np.float32)
    rays[:, :3] = rng.normal(size=(B, 3))
    d = rng.normal(size=(B, 3))
    rays[:, 3:6] = d / np.linalg.norm(d, axis=-1, keepdims=True)
    rays[:, 6], rays[:, 7] = 0.8, 1.8
    return rays


@pytest.mark.parametrize("lindisp", [False, True])
def test_samplers_with_injected_draws(rng, lindisp):
    B, Kc, Kf, Kd = 16, 8, 6, 4
    rays = _rays(rng, B)
    u_c = rng.random((B, Kc)).astype(np.float32)
    np.testing.assert_allclose(
        trs.sample_coarse(t(rays), Kc, lindisp=lindisp, u=t(u_c)).numpy(),
        np.asarray(jrs.sample_coarse(rays, Kc, lindisp=lindisp, u=u_c)),
        atol=1e-6)
    w = rng.random((B, Kc)).astype(np.float32)
    u, uj = (rng.random((B, Kf)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        trs.sample_fine(t(rays), t(w), Kf, Kc, lindisp=lindisp, u=t(u),
                        u_jitter=t(uj)).numpy(),
        np.asarray(jrs.sample_fine(rays, w, Kf, Kc, lindisp=lindisp, u=u,
                                   u_jitter=uj)),
        atol=1e-6)
    depth = rng.random(B).astype(np.float32) + 0.8
    noise = rng.normal(size=(B, Kd)).astype(np.float32) * 20
    np.testing.assert_allclose(
        trs.sample_fine_depth(t(rays), t(depth), Kd, depth_std=0.01,
                              noise=t(noise)).numpy(),
        np.asarray(jrs.sample_fine_depth(rays, depth, Kd, depth_std=0.01,
                                         noise=noise)),
        atol=1e-6)


def test_samplers_draw_from_generator(rng):
    rays = t(_rays(rng, 8))
    a = trs.sample_coarse(rays, 5, generator=torch.Generator().manual_seed(3))
    b = trs.sample_coarse(rays, 5, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert bool(((a >= 0.8) & (a <= 1.8)).all())


@pytest.mark.parametrize("white", [False, True])
def test_composite(rng, white):
    B, K = 12, 10
    out = rng.random((B, K, 4)).astype(np.float32)
    out[..., 3] = rng.normal(size=(B, K)) * 20
    z = np.sort(rng.random((B, K)).astype(np.float32) + 0.8, axis=-1)
    far = np.full((B, 1), 1.9, np.float32)
    ref = jcomp.composite(out, z, far, white_bkgd=white)
    got = tcomp.composite(t(out), t(z), t(far), white_bkgd=white)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)


def test_port_imports_no_jax():
    """Importing every port module leaves jax, flax and the JAX package
    out of sys.modules (checked in a fresh interpreter: this process has
    jax loaded already)."""
    code = textwrap.dedent("""
        import sys
        before = set(sys.modules)
        import pixelnerf_yolo_torch
        import pixelnerf_yolo_torch.convert
        import pixelnerf_yolo_torch.models
        import pixelnerf_yolo_torch.render
        import pixelnerf_yolo_torch.ops.field_mlp
        import pixelnerf_yolo_torch.utils.camera
        import pixelnerf_yolo_torch.config.flagship
        import pixelnerf_yolo_torch.detect
        import pixelnerf_yolo_torch.losses
        new = set(sys.modules) - before
        bad = sorted(m for m in new if m.split(".")[0] in
                     ("jax", "jaxlib", "flax", "pixelnerf_yolo_tpu"))
        assert not bad, bad
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


@pytest.mark.parametrize("n", [3000, 70000])
def test_gather_rows_bf16_sums_the_gradient_in_f32(n):
    """A bf16 table's gather gradient is the f32 sum of its rows' terms,
    rounded once, however many samples share a row (70,000 rows: the
    backward's slices); the forward is torch.gather's."""
    g = torch.Generator().manual_seed(0)
    flat = torch.randn(2, 4, 8, generator=g).bfloat16().requires_grad_()
    idx = torch.randint(0, 4, (2, n), generator=g)
    grad = (torch.rand(2, n, 8, generator=g) * 0.5 + 0.5).bfloat16()
    got = tgs.gather_rows(flat, idx)
    assert torch.equal(got, torch.gather(
        flat.detach(), 1, idx[..., None].expand(-1, -1, 8)))
    got.backward(grad)
    ref = torch.zeros(2, 4, 8, dtype=torch.float64).scatter_add_(
        1, idx[..., None].expand(-1, -1, 8), grad.double())
    torch.testing.assert_close(flat.grad.double(),
                               ref.bfloat16().double(), rtol=2**-8, atol=0)
