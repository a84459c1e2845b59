"""Early ray termination (``renderer.early_terminate``) in the port: the
cases of the JAX package's tests/test_early_terminate.py on the port's
renderer, and the gated render against the JAX package's with the same
weights and draws.

  * f = 1.0 (full capacity) renders bitwise as without the gate;
  * f < 1: the top-C rays of each chunk and scene by coarse weight sum get
    exactly the ungated fine output; the rest keep exactly their coarse
    rgb/depth, their fine weights the coarse ones zero-padded;
  * the gate applies per chunk and per scene; training ignores it.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pixelnerf_yolo_tpu.config.hocon import parse_string as jparse
from pixelnerf_yolo_tpu.models import make_model as jmake_model
from pixelnerf_yolo_tpu.render import make_renderer as jmake_renderer
from pixelnerf_yolo_tpu.utils.camera import gen_rays
from pixelnerf_yolo_torch.config.hocon import parse_string
from pixelnerf_yolo_torch.render import make_renderer
from torch_parity import jax_draws, perturbed_variables, port_model, to_np

RENDER_TOL = 1e-4  # the gated render against JAX's, f32

# tests/test_early_terminate.py's conf
_CONF = """
model {
    use_encoder = True
    use_xyz = True
    use_code = True
    code { num_freqs = 4
           freq_factor = 1.5
           include_input = True }
    use_viewdirs = True
    use_code_viewdirs = False
    mlp_coarse { type = resnet
                 n_blocks = 3
                 d_hidden = 32
                 combine_layer = 2
                 combine_type = average }
    mlp_fine { type = resnet
               n_blocks = 3
               d_hidden = 32
               combine_layer = 2
               combine_type = average }
    encoder { backbone = resnet18
              pretrained = False
              num_layers = 2
              index_padding = zeros }
}
renderer { type = nerf
           n_coarse = 8
           n_fine = 4
           n_fine_depth = 2
           depth_std = 0.01
           sched = []
           white_bkgd = True
           eval_batch_size = 64 }
"""


def _scene(sb=1):
    rng = np.random.default_rng(0)
    images = rng.normal(size=(sb, 2, 3, 32, 32)).astype(np.float32).clip(-1, 1)
    poses = np.stack([np.eye(4, dtype=np.float32) for _ in range(2)])
    poses[:, 2, 3] = 1.3
    return images, np.stack([poses] * sb), np.float32(30.0)


def _rays(poses):
    return np.array(gen_rays(jnp.asarray(poses[0]), 16, 16,
                             jnp.float32(30.0), 0.8, 1.8)).reshape(1, -1,
                                                                    8)[:, :256]


@pytest.fixture(scope="module")
def setup():
    """The port's model with the JAX model's weights, its cond and
    renderer, the rays, JAX's draws and the ungated render."""
    jm = jmake_model(jparse(_CONF).get_config("model"))
    images, poses, focal = _scene()
    v = perturbed_variables(jm, images[0])
    conf = parse_string(_CONF)
    tm = port_model(conf, v)
    with torch.no_grad():
        tc = tm.encode(images, poses, focal)
    renderer = make_renderer(conf, device="cpu")
    rays = _rays(poses)
    draws = jax_draws(jmake_renderer(jparse(_CONF)), jax.random.PRNGKey(1),
                      rays.shape[1])
    base = renderer(tm, tc, rays, draws=draws, want_weights=True)
    return jm, v, tm, tc, renderer, rays, draws, base


def _kept(wsum, capacity):
    """The top-C rays by weight sum, lower index first among equal sums."""
    mask = np.zeros(wsum.shape[-1], bool)
    mask[np.argsort(-wsum, kind="stable")[:capacity]] = True
    return mask


def test_full_capacity_is_bitwise_ungated(setup):
    _, _, tm, tc, renderer, rays, draws, base = setup
    gated = dataclasses.replace(renderer, early_terminate=1.0)
    out = gated(tm, tc, rays, draws=draws, want_weights=True)
    for branch in ("coarse", "fine"):
        for k in ("rgb", "depth", "weights"):
            assert torch.equal(out[branch][k], base[branch][k]), (branch, k)


def test_gate_splits_rays_exactly(setup):
    _, _, tm, tc, renderer, rays, draws, base = setup
    gated = dataclasses.replace(renderer, early_terminate=0.5)
    out = gated(tm, tc, rays, draws=draws, want_weights=True)
    Cc = gated._gated_capacity(rays.shape[1])
    assert Cc == 128
    mask = _kept(to_np(base["coarse"]["weights"])[0].sum(-1), Cc)
    f_rgb, f_depth = to_np(out["fine"]["rgb"])[0], to_np(out["fine"]["depth"])[0]
    c_rgb, c_depth = (to_np(base["coarse"]["rgb"])[0],
                      to_np(base["coarse"]["depth"])[0])
    np.testing.assert_array_equal(f_rgb[~mask], c_rgb[~mask])
    np.testing.assert_array_equal(f_depth[~mask], c_depth[~mask])
    np.testing.assert_array_equal(f_rgb[mask], to_np(base["fine"]["rgb"])[0][mask])
    np.testing.assert_array_equal(f_depth[mask],
                                  to_np(base["fine"]["depth"])[0][mask])
    f_w = to_np(out["fine"]["weights"])[0]
    c_w = to_np(base["coarse"]["weights"])[0]
    np.testing.assert_array_equal(f_w[~mask][:, :c_w.shape[1]], c_w[~mask])
    assert not f_w[~mask][:, c_w.shape[1]:].any()


def _small_chunk(renderer, cb):
    """A copy of ``renderer`` whose chunk budget gives cb-ray chunks."""

    class _Tiny(type(renderer)):
        def _chunk_rays(self, n_rays_per_scene, n_views=1, latent_width=512,
                        grad_remat=False):
            return min(cb, n_rays_per_scene)

    return _Tiny(**{f.name: getattr(renderer, f.name)
                    for f in dataclasses.fields(renderer)})


def test_gate_applies_per_chunk(setup):
    _, _, tm, tc, renderer, rays, _, _ = setup
    big = np.concatenate([rays] * 4, axis=1)  # (1, 1024, 8)
    cb = 256
    draws = renderer.draw(big.shape[1], torch.Generator().manual_seed(2),
                          "cpu")
    gated = _small_chunk(dataclasses.replace(renderer, early_terminate=0.25),
                         cb)
    out = gated(tm, tc, big, draws=draws)
    ung = _small_chunk(renderer, cb)(tm, tc, big, draws=draws,
                                     want_weights=True)
    wsum = to_np(ung["coarse"]["weights"])[0].sum(-1)
    Cc = gated._gated_capacity(cb)
    n_kept = 0
    for start in range(0, big.shape[1], cb):
        sl = slice(start, start + cb)
        mask = _kept(wsum[sl], Cc)
        n_kept += mask.sum()
        got = to_np(out["fine"]["rgb"])[0, sl]
        np.testing.assert_array_equal(got[~mask],
                                      to_np(ung["coarse"]["rgb"])[0, sl][~mask])
        np.testing.assert_array_equal(got[mask],
                                      to_np(ung["fine"]["rgb"])[0, sl][mask])
    assert 0 < n_kept < big.shape[1]


def test_gate_per_scene_in_superbatch(setup):
    _, v, tm, _, renderer, rays, _, _ = setup
    images, poses, focal = _scene(sb=2)
    with torch.no_grad():
        cond2 = tm.encode(images, poses, focal)
    rays2 = np.stack([rays[0], rays[0][::-1]])  # (2, B, 8)
    draws = renderer.draw(2 * rays2.shape[1],
                          torch.Generator().manual_seed(3), "cpu")
    gated = dataclasses.replace(renderer, early_terminate=0.5)
    out = gated(tm, cond2, rays2, draws=draws)
    ung = renderer(tm, cond2, rays2, draws=draws, want_weights=True)
    B = rays2.shape[1]
    Cc = gated._gated_capacity(B)
    wsum = to_np(ung["coarse"]["weights"]).sum(-1)  # (2, B)
    for s in range(2):
        mask = _kept(wsum[s], Cc)
        f_rgb = to_np(out["fine"]["rgb"])[s]
        np.testing.assert_array_equal(f_rgb[~mask],
                                      to_np(ung["coarse"]["rgb"])[s][~mask])
        np.testing.assert_array_equal(f_rgb[mask],
                                      to_np(ung["fine"]["rgb"])[s][mask])
        assert 0 < mask.sum() < B


def test_gate_ignored_in_training(setup):
    _, _, tm, tc, renderer, rays, draws, _ = setup
    gated = dataclasses.replace(renderer, early_terminate=0.25)
    out = gated.render(tm, tc, rays, draws=draws, train=True)
    ung = renderer.render(tm, tc, rays, draws=draws, train=True)
    for k in ("rgb", "depth"):
        assert torch.equal(out["fine"][k], ung["fine"][k])


def test_from_conf_parses_early_terminate():
    conf = parse_string(_CONF.replace(
        "eval_batch_size = 64", "eval_batch_size = 64\nearly_terminate = 0.375"))
    renderer = make_renderer(conf, device="cpu")
    assert renderer.early_terminate == 0.375
    assert renderer._gated_capacity(8192) == 3072
    assert renderer._gated_capacity(10) == 8  # ⌈3.75⌉ -> 8
    assert renderer._gated_capacity(5) == 5  # capped at the chunk


@pytest.mark.parametrize("ties", [False, True])
def test_gated_render_matches_jax(setup, ties):
    """f = 0.5 against JAX's gated render with the same draws.  ties: a
    sigma bias of -1e4 in both packages makes every coarse weight sum 0, so
    the gate keeps the first C rays by the tie rule (lax.top_k's lower
    index first) in both."""
    jm, v, _, _, renderer, rays, draws, _ = setup
    if ties:
        v = jax.tree.map(np.copy, v)
        for m in ("mlp_coarse", "mlp_fine"):
            v["params"][m]["lin_out"]["bias"][3] = -1e4
    tm = port_model(parse_string(_CONF), v)
    images, poses, focal = _scene()
    with torch.no_grad():
        tc = tm.encode(images, poses, focal)
    jc = jm.encode(v, jnp.asarray(images), jnp.asarray(poses),
                   jnp.asarray(focal))
    jr = dataclasses.replace(jmake_renderer(jparse(_CONF)),
                             early_terminate=0.5)
    ref = jr(jm, v, jc, jnp.asarray(rays), jax.random.PRNGKey(1),
             want_weights=True)
    gated = dataclasses.replace(renderer, early_terminate=0.5)
    out = gated(tm, tc, rays, draws=draws, want_weights=True)
    for branch in ("coarse", "fine"):
        for k in ("rgb", "depth", "weights"):
            np.testing.assert_allclose(to_np(out[branch][k]),
                                       np.asarray(ref[branch][k]),
                                       atol=RENDER_TOL, err_msg=(branch, k))
    # the same rays kept: JAX's lax.top_k against the port's rule
    jw = np.asarray(ref["coarse"]["weights"])[0].sum(-1)
    _, idx = jax.lax.top_k(jnp.asarray(jw), 128)
    want = np.zeros(rays.shape[1], bool)
    want[np.asarray(idx)] = True
    got = _kept(to_np(out["coarse"]["weights"])[0].sum(-1), 128)
    np.testing.assert_array_equal(got, want)
    if ties:
        assert not jw.any() and want[:128].all()
