"""The port's YOLO mode against the JAX package on the CPU: the ELAN
backbone and the custom encoder, weight conversion, YOLO rays, the
aggregation, the model's encode + forward and the whole YoloRenderer call,
with the same weights and draws.

The ELAN backbone has no width knob, so these run it at its full 1792-d
output, on 64x64 source images, with d_hidden 64 and 16 coarse samples.
At these widths the JAX package's f32 field takes its Pallas kernels
(``pick_tile`` fits at d_hidden 64).  The port's ``fits`` takes f32 at
NS=3 (pre_combine_pe streams the latent; post_combine holds no latent)
but refuses it at NS=1 (full_pe's 32 x 1792 f32 latent tile needs 249,856
B of shared memory), so the f32 comparison with ``use_fused_mlp = true``
is port-twins against JAX-kernels at NS=3 and port-plain against
JAX-kernel at NS=1; in bf16 the port runs the kernels' plain twins."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pixelnerf_yolo_tpu.config import hocon as jhocon
from pixelnerf_yolo_tpu.models import make_model as jmake_model
from pixelnerf_yolo_tpu.ops import composite as jcomp
from pixelnerf_yolo_tpu.render import make_renderer as jmake_renderer
from pixelnerf_yolo_tpu.utils.camera import gen_rays_yolo as jgen_rays_yolo
from pixelnerf_yolo_torch.config import hocon as thocon
from pixelnerf_yolo_torch.convert import from_jax_variables
from pixelnerf_yolo_torch.models import make_model
from pixelnerf_yolo_torch.models.yolo_backbone import YOLOBackbone
from pixelnerf_yolo_torch.ops import composite as tcomp
from pixelnerf_yolo_torch.ops import field_mlp
from pixelnerf_yolo_torch.render import YoloRenderer, make_renderer
from pixelnerf_yolo_torch.utils.camera import gen_rays_yolo
from torch_parity import (YOLO_FAR, YOLO_NEAR, jax_yolo_draws,
                          perturbed_variables, port_model, small_yolo,
                          to_np, yolo_scene)

FWD_TOL = 2e-5  # module-level f32 forwards
RENDER_TOL = 1e-4  # whole YoloRenderer call, f32
# bf16 field: the port's twins against the JAX package's Pallas kernels
# (interpret mode), or plain against flax, the same rounding points; both
# gather a bf16 table of <= 1024 rows (here 64) at the one-hot form's
# rounding points.  From JAX's own latent table the gathered latents agree
# exactly and the outputs to 2.4e-7 (BF16_FIELD_TOL); from each package's
# own table, which the bf16 encoders round differently (45% of its
# entries equal, up to 7.8e-3 apart), the outputs differ by up to 1.8e-2
# on values up to 3.3 (measured on the CPU; 2.6e-2 before the one-hot
# form was ported, under a bound of 0.1)
BF16_TOL = 3e-2
BF16_FIELD_TOL = 1e-5
GRID = 8  # rays on a GRID x GRID cell grid of the 64x64 target view
N_RAYS = 40


@pytest.fixture(scope="module")
def jax_side():
    """One JAX YOLO model (f32) and its variables for the whole file; BN
    statistics moved off their init so the conversion is exercised."""
    conf = small_yolo()
    jm = jmake_model(conf.get_config("model"))
    images = yolo_scene(ns=3)[0]
    return conf, jm, perturbed_variables(jm, images[0], encoder_stats=True)


def _rays(target, focal, c):
    cs = 64 // GRID  # cell size in pixels
    rays = jgen_rays_yolo(jnp.asarray(target), GRID, GRID,
                          jnp.asarray(focal[0] / cs), jnp.asarray(c[0] / cs),
                          YOLO_NEAR, YOLO_FAR)
    return np.array(rays).reshape(1, -1, 8)[:, :N_RAYS]


def test_yolo_conf_parses_the_same():
    """The YOLO flagship and conf/exp/yolo.conf (with its includes) read
    the same through both parsers."""
    from __graft_entry__ import _flagship
    from pixelnerf_yolo_torch.config.flagship import flagship_conf

    for dtype in ("float32", "bfloat16"):
        args = dict(yolo=True, backbone="custom", compute_dtype=dtype)
        assert flagship_conf(**args).to_dict() == _flagship(**args).to_dict()
    got = thocon.parse_file("conf/exp/yolo.conf")
    assert got.to_dict() == jhocon.parse_file("conf/exp/yolo.conf").to_dict()
    assert got.get_bool("model.mlp_coarse.yolo")
    assert got.get_string("model.encoder.backbone") == "custom"
    assert got.get_string("renderer.type") == "yolo"


def test_backbone_matches_flax(jax_side):
    conf, jm, v = jax_side
    x = np.transpose(yolo_scene(ns=3)[0][0], (0, 2, 3, 1))
    from pixelnerf_yolo_tpu.models.yolo_backbone import (
        YOLOBackbone as JYOLOBackbone)

    enc = {"params": v["params"]["encoder"]["model"],
           "batch_stats": v["batch_stats"]["encoder"]["model"]}
    ref = JYOLOBackbone().apply(enc, jnp.asarray(x))
    tm = port_model(conf, v)
    assert isinstance(tm.encoder.model, YOLOBackbone)
    with torch.no_grad():
        got = tm.encoder.model(torch.from_numpy(x).permute(0, 3, 1, 2),
                               torch.float32)
    for g, r, (c, s) in zip(got, ref, [(256, 8), (512, 4), (1024, 2)]):
        assert g.shape == (3, c, s, s)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(r), atol=FWD_TOL)


def test_encoder_matches(jax_side):
    """P4 and P5 resized to P3's 8x8 (align_corners on) and concatenated."""
    conf, jm, v = jax_side
    x = np.transpose(yolo_scene(ns=3)[0][0], (0, 2, 3, 1))
    ref = np.asarray(jm.encoder.apply(
        {"params": v["params"]["encoder"],
         "batch_stats": v["batch_stats"]["encoder"]}, jnp.asarray(x)))
    tm = port_model(conf, v)
    assert tm.encoder.latent_size == 1792
    with torch.no_grad():
        got = tm.encoder(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (3, 8, 8, 1792)
    np.testing.assert_allclose(got, ref, atol=FWD_TOL)


def test_from_jax_variables_custom_tree(jax_side):
    """Every flax leaf lands on one port key, and a leaf the map does not
    know raises."""
    conf, _, v = jax_side
    sd = from_jax_variables(v)
    n_leaves = len(jax.tree_util.tree_leaves(v))
    n_bn = sum(k.endswith("num_batches_tracked") for k in sd)
    assert len(sd) - n_bn == n_leaves
    k = v["params"]["encoder"]["model"]["ELANBlock_2"]["ConvBnAct_6"][
        "Conv_0"]["kernel"]
    np.testing.assert_array_equal(
        sd["encoder.model.ELANBlock_2.ConvBnAct_6.Conv_0.weight"].numpy(),
        np.transpose(k, (3, 2, 0, 1)))
    s = v["batch_stats"]["encoder"]["model"]["ConvBnAct_3"]["BatchNorm_0"]
    np.testing.assert_array_equal(
        sd["encoder.model.ConvBnAct_3.BatchNorm_0.running_var"].numpy(),
        s["var"])
    model = make_model(conf.get_config("model"), device="cpu")
    assert set(model.state_dict()) == set(sd)
    bad = jax.tree.map(lambda x: x, v)
    bad["params"]["encoder"]["model"]["ConvBnAct_0"]["Dense_0"] = {
        "kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(NotImplementedError, match="Dense_0"):
        from_jax_variables(bad)


def test_gen_rays_yolo_matches():
    """f32 torch.linalg.inv against jnp.linalg.inv: the rays agree to
    within an f32 ulp (measured max 1.5e-8 on values up to 3)."""
    _, poses, focal, c, target = yolo_scene(ns=3)
    allp = np.concatenate([target, poses[0]])
    allp[1, :3, :3] = np.asarray([[0.8, -0.6, 0.0], [0.6, 0.8, 0.0],
                                  [0.0, 0.0, 1.0]], np.float32)
    ref = np.asarray(jgen_rays_yolo(jnp.asarray(allp), 12, 10,
                                    jnp.asarray([50.0, 55.0]),
                                    jnp.asarray([6.0, 5.5]), 1.0, 3.0))
    got = gen_rays_yolo(torch.from_numpy(allp), 12, 10,
                        torch.tensor([50.0, 55.0]), torch.tensor([6.0, 5.5]),
                        1.0, 3.0).numpy()
    assert got.shape == ref.shape == (4, 10, 12, 8)
    np.testing.assert_allclose(got, ref, atol=1e-6)
    # unnormalized directions: z == 1 in the target camera's frame
    np.testing.assert_allclose(got[0, ..., 5], 1.0, atol=1e-7)


@pytest.mark.parametrize("mode,gamma", [("max", 1.0), ("soft_count", 1.0),
                                        ("gated_count", 1.0),
                                        ("soft_count", 2.0)])
def test_yolo_aggregate_matches(rng, mode, gamma):
    out = (rng.normal(size=(9, 16, 3, 7)) * 3).astype(np.float32)
    ref = np.asarray(jcomp.yolo_aggregate(jnp.asarray(out), mode=mode,
                                          soft_count=4.0, gamma=gamma))
    got = tcomp.yolo_aggregate(torch.from_numpy(out), mode=mode,
                               soft_count=4.0, gamma=gamma).numpy()
    assert got.shape == ref.shape == (9, 3, 7)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)


def _points(rng, n=48):
    """World points at the target view's sample depths, the first at view
    0's camera centre (camera xyz = 0: a NaN uv)."""
    xyz = rng.uniform(-0.6, 0.6, size=(1, n, 3)).astype(np.float32)
    xyz[0, :, 2] = rng.uniform(YOLO_NEAR, YOLO_FAR, size=n)
    xyz[0, 0] = [-0.05, 0.03, (YOLO_NEAR + YOLO_FAR) / 2]
    vd = rng.normal(size=(1, n, 3)).astype(np.float32)
    return xyz, vd


@pytest.mark.parametrize("fused", ["true", "false"])
@pytest.mark.parametrize("ns", [1, 3])
def test_encode_and_forward_match(jax_side, rng, fused, ns):
    conf, _, v = jax_side
    conf = small_yolo(use_fused_mlp=fused)
    jm = jmake_model(conf.get_config("model"))
    tm = port_model(conf, v)
    images, poses, focal, c, _ = yolo_scene(ns=ns)
    jc = jm.encode(v, jnp.asarray(images), jnp.asarray(poses),
                   jnp.asarray(focal), c=jnp.asarray(c))
    tc = tm.encode(images, poses, focal, c=c)
    np.testing.assert_allclose(to_np(tc.latent_flat),
                               np.asarray(jc.latent_flat), atol=FWD_TOL)
    np.testing.assert_array_equal(to_np(tc.poses), np.asarray(jc.poses))
    np.testing.assert_array_equal(to_np(tc.focal), np.asarray(jc.focal))
    xyz, vd = _points(rng)
    lat = to_np(tm.project_latent(tc, torch.from_numpy(xyz)))
    z_cam = (np.einsum("vj,nj->vn", poses[0, :, 2, :3], xyz[0])
             + poses[0, :, 2, 3, None])
    behind = z_cam >= 0  # (NS, n): latents zeroed there
    assert behind.any() and (~behind).any()
    assert not np.abs(lat[behind]).any()
    assert np.isfinite(lat).all() and np.abs(lat[~behind]).max() > 0
    field_mlp.reset_launches()
    ref = np.asarray(jm.forward(v, jc, jnp.asarray(xyz),
                                viewdirs=jnp.asarray(vd)))
    got = to_np(tm.forward(tc, torch.from_numpy(xyz),
                           viewdirs=torch.from_numpy(vd)))
    assert got.shape == ref.shape == (1, 48, 21)
    np.testing.assert_allclose(got, ref, atol=FWD_TOL)
    assert sum(field_mlp.launches.values()) == 0


@pytest.mark.parametrize("fused", ["true", "false"])
def test_bf16_forward_matches(jax_side, rng, fused):
    """bf16, NS=3.  Fused: the port's twins (pre_combine_pe, f32 view
    mean, post_combine) against the JAX package's Pallas kernels; plain:
    the port's ResnetFC against flax."""
    _, _, v = jax_side
    conf = small_yolo("bfloat16", use_fused_mlp=fused)
    jm = jmake_model(conf.get_config("model"))
    tm = port_model(conf, v)
    assert tm._can_fuse(tm.mlp_coarse, 3) is (fused == "true")
    images, poses, focal, c, _ = yolo_scene(ns=3)
    jc = jm.encode(v, jnp.asarray(images), jnp.asarray(poses),
                   jnp.asarray(focal), c=jnp.asarray(c))
    tc = tm.encode(images, poses, focal, c=c)
    xyz, vd = _points(rng)
    ref = np.asarray(jm.forward(v, jc, jnp.asarray(xyz),
                                viewdirs=jnp.asarray(vd)))
    got = to_np(tm.forward(tc, torch.from_numpy(xyz),
                           viewdirs=torch.from_numpy(vd)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=BF16_TOL)
    # the gather and the field alone: from JAX's latent table
    table = torch.from_numpy(np.array(jc.latent_flat.astype(jnp.float32)))
    tc = dataclasses.replace(tc, latent_flat=table.to(torch.bfloat16))
    np.testing.assert_array_equal(
        to_np(tm.project_latent(tc, torch.from_numpy(xyz))),
        np.asarray(jm.project_latent(v, jc, jnp.asarray(xyz)), np.float32))
    got = to_np(tm.forward(tc, torch.from_numpy(xyz),
                           viewdirs=torch.from_numpy(vd)))
    np.testing.assert_allclose(got, ref, atol=BF16_FIELD_TOL)


@pytest.fixture(scope="module")
def render_ref(jax_side):
    """The JAX YoloRenderer call on the NS=3 scene, and its draws."""
    conf, jm, v = jax_side
    images, poses, focal, c, target = yolo_scene(ns=3)
    jc = jm.encode(v, jnp.asarray(images), jnp.asarray(poses),
                   jnp.asarray(focal), c=jnp.asarray(c))
    rays = _rays(target, focal, c)
    jr = jmake_renderer(conf)
    key = jax.random.PRNGKey(3)
    out = np.asarray(jr(jm, v, jc, jnp.asarray(rays), key))
    return rays, jax_yolo_draws(key, N_RAYS, jr.n_coarse), out


def _port_render(conf, v, rays, u, renderer=None):
    tm = port_model(conf, v)
    images, poses, focal, c, _ = yolo_scene(ns=3)
    tc = tm.encode(images, poses, focal, c=c)
    tr = renderer or make_renderer(conf, device="cpu")
    return to_np(tr(tm, tc, rays, u=u))


@pytest.mark.parametrize("fused", ["auto", "false"])
def test_render_matches_jax(jax_side, render_ref, fused):
    _, _, v = jax_side
    rays, u, ref = render_ref
    conf = small_yolo(use_fused_mlp=fused)
    got = _port_render(conf, v, rays, u)
    assert got.shape == ref.shape == (1, N_RAYS, 3, 7)
    np.testing.assert_allclose(got, ref, atol=RENDER_TOL)
    # not degenerate: the probabilities spread inside (0, 1)
    assert 0.05 < ref[..., 0].min() and ref[..., 0].max() < 0.999
    assert np.ptp(ref[..., 0]) > 0.01


@pytest.mark.parametrize("chunk", [8, 16])
def test_chunk_size_invariance(jax_side, render_ref, chunk):
    """One draw over the whole batch: the chunk size does not matter; 16
    pads 40 rays to 48 with the scene's first ray."""
    conf, _, v = jax_side
    rays, u, _ = render_ref

    class Chunked(YoloRenderer):
        def chunk_rays_for(self, *a, **k):
            return chunk

    base = make_renderer(conf, device="cpu")
    small = Chunked(**{f: getattr(base, f)
                       for f in base.__dataclass_fields__})
    full = _port_render(conf, v, rays, u)
    got = _port_render(conf, v, rays, u, renderer=small)
    np.testing.assert_allclose(got, full, atol=1e-6)
    # rays without the scene axis give (B, A, 7)
    tm = port_model(conf, v)
    images, poses, focal, c, _ = yolo_scene(ns=3)
    flat = small(tm, tm.encode(images, poses, focal, c=c), rays[0], u=u)
    np.testing.assert_allclose(to_np(flat), full[0], atol=1e-6)


def test_chunk_rays_for_matches_jax():
    """The bench's YOLO cell: 16,384 rays, NS=3, 1792-d latents, 128
    samples -> 1,560 rays per chunk (11 chunks of 1,490)."""
    from __graft_entry__ import _flagship

    conf = _flagship(yolo=True, backbone="custom")
    jr, tr = jmake_renderer(conf), make_renderer(conf, device="cpu")
    for args in [(16384, 3, 1792), (40, 3, 1792), (65536, 1, 512, 2)]:
        assert tr.chunk_rays_for(*args) == jr.chunk_rays_for(*args)
    assert tr.chunk_rays_for(16384, 3, 1792) == 1560


def test_render_draws_from_generator(jax_side, render_ref):
    conf, _, v = jax_side
    rays = render_ref[0]
    tm = port_model(conf, v)
    images, poses, focal, c, _ = yolo_scene(ns=3)
    tc = tm.encode(images, poses, focal, c=c)
    tr = make_renderer(conf, device="cpu")
    a, b = (tr(tm, tc, rays, generator=torch.Generator().manual_seed(5))
            for _ in range(2))
    assert torch.equal(a, b) and a.shape == (1, N_RAYS, 3, 7)
    assert bool(torch.isfinite(a).all())


def test_unported_yolo_options_raise():
    # latent_preproject is ported: the plain bf16 route pre-projects the
    # table (n_lin_z x d_hidden = 3 x 64 wide)
    conf = small_yolo("bfloat16", use_fused_mlp="false")
    conf.put("model.latent_preproject", True)
    tm = make_model(conf.get_config("model"), device="cpu")
    images, poses, focal, c, _ = yolo_scene(ns=3)
    with torch.no_grad():
        tc = tm.encode(images, poses, focal, c=c)
    assert tc.latent_projected and tc.latent_flat.shape[-1] == 3 * 64
    # the conv encoder is ported (ROADMAP.md Queue 1 item 21): a YOLO
    # model builds on its 128-d latent; a backbone neither package has
    # still raises
    conf = small_yolo()
    conf.put("model.encoder.backbone", "conv")
    tm = make_model(conf.get_config("model"), device="cpu")
    assert tm.encoder.latent_size == tm.mlp_coarse.d_latent == 128
    conf.put("model.encoder.backbone", "resnet50")
    with pytest.raises(NotImplementedError, match="resnet50"):
        make_model(conf.get_config("model"), device="cpu")
