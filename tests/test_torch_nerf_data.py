"""The NeRF trainer's host side against the JAX package's, on the CPU:
the SRN, DVR (ShapeNet, gen_ and DTU) and multi-object datasets item by
item on synthetic scene directories, every format of ``get_split_dataset``,
the pixel samplers and host ray generation under equal numpy Generators,
the RGB and alpha losses on seeded arrays, and the PSNR and SSIM
metrics."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from synth_data import (make_dvr_dataset, make_multi_object_dataset,
                        make_srn_dataset)


def _roots(tmp, maker, name, **kw):
    root = str(tmp / name)
    for stage in ("train", "val", "test"):
        maker(root, stage=stage, **kw)
    return root


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("nerf_data")
    return {
        "srn": _roots(tmp, make_srn_dataset, "cars", n_objs=2, n_views=4,
                      img_size=32),
        "dvr": _roots(tmp, make_dvr_dataset, "dvr", n_cats=2, n_objs=2,
                      n_views=3, img_size=32),
        "dvr_gen": _roots(tmp, make_dvr_dataset, "gen", n_cats=1, n_objs=2,
                          n_views=3, img_size=32, list_prefix="gen_"),
        "dvr_dtu": _roots(tmp, make_dvr_dataset, "dtu", sub_format="dtu",
                          n_cats=1, n_objs=2, n_views=3, img_size=32),
        "multi_obj": _roots(tmp, make_multi_object_dataset, "multi",
                            n_scenes=2, n_views=3, img_size=32),
    }


def _assert_items_equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            assert type(x) is type(y) and x == y, k


@pytest.mark.parametrize("fmt", ["srn", "dvr", "dvr_gen", "dvr_dtu",
                                 "multi_obj"])
def test_split_datasets_match_jax(roots, fmt):
    """get_split_dataset: the same classes, flags and z bounds, the same
    lengths, and every key of every item of every split exactly equal
    (the DTU train split's color jitter under equal Generators)."""
    from pixelnerf_yolo_tpu.data import get_split_dataset as jax_split
    from pixelnerf_yolo_torch.data import get_split_dataset

    ref, got = jax_split(fmt, roots[fmt]), get_split_dataset(fmt,
                                                             roots[fmt])
    for r, g in zip(ref, got):
        assert type(r).__name__ == type(g).__name__
        assert len(r) == len(g) > 0
        assert (r.z_near, r.z_far, getattr(r, "lindisp", None)) == (
            g.z_near, g.z_far, getattr(g, "lindisp", None))
        if hasattr(r, "_rng"):  # the color jitter wrapper
            r._rng, g._rng = (np.random.default_rng(0),
                              np.random.default_rng(0))
        for i in range(len(r)):
            _assert_items_equal(r[i], g[i])
    if fmt == "dvr_dtu":
        assert got[0].sub_format == "dtu" and got[1].max_imgs == 49
        assert get_split_dataset(fmt, roots[fmt],
                                 training=False)[1].max_imgs == 100000


def test_srn_image_size_and_dvr_decompose(roots):
    """SRN read at another size (focal, c and boxes scaled, area resize),
    and the DTU projection decomposition, against the JAX package."""
    from pixelnerf_yolo_tpu.data import SRNDataset as JaxSRN
    from pixelnerf_yolo_tpu.data.dvr import decompose_projection as jax_dec
    from pixelnerf_yolo_torch.data import SRNDataset
    from pixelnerf_yolo_torch.data.dvr import decompose_projection

    for size in ((32, 32), (16, 16), (64, 64)):
        _assert_items_equal(JaxSRN(roots["srn"], image_size=size)[1],
                            SRNDataset(roots["srn"], image_size=size)[1])
    P = np.random.default_rng(0).normal(size=(3, 4))
    for r, g in zip(jax_dec(P), decompose_projection(P)):
        np.testing.assert_array_equal(r, g)


def test_unsupported_format_raises():
    from pixelnerf_yolo_torch.data import get_split_dataset

    with pytest.raises(NotImplementedError, match="Unsupported"):
        get_split_dataset("llff", "/nonexistent")


# -- samplers and host rays ---------------------------------------------------


def test_samplers_match_jax():
    """bbox_sample and masked_sample draw the same pixels in the same
    order from equal Generators, and leave them in equal states."""
    from pixelnerf_yolo_tpu.utils import sampling as jax_sampling
    from pixelnerf_yolo_torch.utils import sampling

    rng = np.random.default_rng(0)
    bboxes = np.array([[3, 4, 20, 25], [0, 0, 31, 31], [10, 2, 12, 30]],
                      np.float32)
    masks = (rng.uniform(size=(3, 1, 16, 16)) > 0.6).astype(np.float32)
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(3):
        np.testing.assert_array_equal(
            jax_sampling.bbox_sample(bboxes, 97, rng=a),
            sampling.bbox_sample(bboxes, 97, rng=b))
        np.testing.assert_array_equal(
            jax_sampling.masked_sample(masks, 50, 0.7, rng=a),
            sampling.masked_sample(masks, 50, 0.7, rng=b))
    assert a.bit_generator.state == b.bit_generator.state
    pix = sampling.bbox_sample(bboxes, 500, rng=b)
    for img in range(3):
        sel = pix[pix[:, 0] == img]
        x0, y0, x1, y1 = bboxes[img]
        assert ((sel[:, 2] >= x0) & (sel[:, 2] <= x1)).all()
        assert ((sel[:, 1] >= y0) & (sel[:, 1] <= y1)).all()


@pytest.mark.parametrize("focal,c", [(np.float32(30.0), None),
                                     (np.array([30.0, 33.0], np.float32),
                                      np.array([15.5, 16.5], np.float32))])
def test_gen_rays_np_matches_jax(focal, c):
    """gen_rays_np equal to the JAX package's, and to the port's device
    gen_rays within f32 rounding."""
    from pixelnerf_yolo_tpu.utils.camera import gen_rays_np as jax_rays
    from pixelnerf_yolo_torch.utils.camera import gen_rays, gen_rays_np

    rng = np.random.default_rng(1)
    poses = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    poses[:, :3, 3] = rng.normal(size=(2, 3))
    got = gen_rays_np(poses, 24, 20, focal, 0.8, 1.8, c=c)
    np.testing.assert_array_equal(got, jax_rays(poses, 24, 20, focal, 0.8,
                                                1.8, c=c))
    dev = gen_rays(torch.from_numpy(poses), 24, 20, torch.as_tensor(focal),
                   0.8, 1.8, c=None if c is None else torch.from_numpy(c))
    np.testing.assert_allclose(got, dev.numpy(), rtol=0, atol=1e-6)


# -- losses ---------------------------------------------------------------------


def _conf(parse, **kv):
    return parse("\n".join(f"{k} = {v}" for k, v in kv.items()))


@pytest.mark.parametrize("use_l1", [False, True])
def test_rgb_losses_match_jax(use_l1):
    from pixelnerf_yolo_tpu.config.hocon import parse_string as jparse
    from pixelnerf_yolo_tpu.losses import rgb as jrgb
    from pixelnerf_yolo_torch.config.hocon import parse_string
    from pixelnerf_yolo_torch.losses import (RGBWithBackground,
                                             RGBWithUncertainty, get_rgb_loss,
                                             weighted_rgb_loss)

    rng = np.random.default_rng(2)
    out, tgt = rng.uniform(size=(2, 2, 40, 3)).astype(np.float32)
    beta = rng.uniform(0.5, 2.0, size=(2, 40)).astype(np.float32)
    w = (rng.uniform(size=(2, 40)) > 0.3).astype(np.float32)
    t = {k: torch.from_numpy(x) for k, x in
         (("o", out), ("t", tgt), ("b", beta), ("w", w))}
    j = {k: jnp.asarray(x) for k, x in
         (("o", out), ("t", tgt), ("b", beta), ("w", w))}
    conf, jconf = (_conf(p, use_l1=use_l1) for p in (parse_string, jparse))
    crit, jcrit = get_rgb_loss(conf), jrgb.get_rgb_loss(jconf)
    pairs = [
        (crit(t["o"], t["t"]), jcrit(j["o"], j["t"])),
        (weighted_rgb_loss(crit, t["o"], t["t"], t["w"]),
         jrgb.weighted_rgb_loss(jcrit, j["o"], j["t"], j["w"])),
        (weighted_rgb_loss(crit, t["o"], t["t"], None),
         jrgb.weighted_rgb_loss(jcrit, j["o"], j["t"], None)),
        (RGBWithUncertainty(conf)(t["o"], t["t"], t["b"]),
         jrgb.RGBWithUncertainty(jconf)(j["o"], j["t"], j["b"])),
        (RGBWithBackground(conf)(t["o"], t["t"], t["b"]),
         jrgb.RGBWithBackground(jconf)(j["o"], j["t"], j["b"])),
    ]
    for got, ref in pairs:
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    # the weighted form: rays of weight 0 drop out; no ray at all gives 0
    keep = w[0] > 0
    np.testing.assert_allclose(
        float(weighted_rgb_loss(crit, t["o"][0], t["t"][0], t["w"][0])),
        float(crit(t["o"][0][torch.from_numpy(keep)],
                   t["t"][0][torch.from_numpy(keep)])), rtol=1e-6)
    assert float(weighted_rgb_loss(crit, t["o"], t["t"],
                                   torch.zeros(2, 40))) == 0.0
    fine = get_rgb_loss(_conf(parse_string, use_l1=use_l1,
                              use_uncertainty=True), coarse=False)
    assert isinstance(fine, RGBWithUncertainty)
    with pytest.raises(TypeError, match="elementwise"):
        weighted_rgb_loss(fine, t["o"], t["t"], t["w"])


@pytest.mark.parametrize("force_opaque", [False, True])
def test_alpha_loss_matches_jax(force_opaque):
    from pixelnerf_yolo_tpu.config.hocon import parse_string as jparse
    from pixelnerf_yolo_tpu.losses.rgb import get_alpha_loss as jget
    from pixelnerf_yolo_torch.config.hocon import parse_string
    from pixelnerf_yolo_torch.losses import AlphaLossNV2, get_alpha_loss

    kv = dict(lambda_alpha=0.3, clamp_alpha=2.5, init_epoch=2,
              force_opaque=force_opaque)
    loss = get_alpha_loss(_conf(parse_string, **kv))
    ref = jget(_conf(jparse, **kv))
    assert isinstance(loss, AlphaLossNV2)
    alpha = np.random.default_rng(3).uniform(size=(64,)).astype(np.float32)
    alpha[:4] = [0.0, 1.0, 0.005, 0.999]
    for epoch in (0, 2, 5):
        np.testing.assert_allclose(
            float(loss(torch.from_numpy(alpha), epoch)),
            float(ref(jnp.asarray(alpha), epoch)), rtol=1e-6, atol=1e-7)
    assert float(loss(torch.from_numpy(alpha), 1)) == 0.0


# -- metrics --------------------------------------------------------------------


def test_metrics_match_jax():
    from pixelnerf_yolo_tpu.utils import metrics as jmetrics
    from pixelnerf_yolo_torch.utils import metrics

    rng = np.random.default_rng(4)
    a = rng.uniform(size=(24, 20, 3))
    b = np.clip(a + rng.normal(scale=0.05, size=a.shape), 0, 1)
    assert abs(metrics.psnr(a, b) - jmetrics.psnr(a, b)) <= 1e-10
    assert abs(metrics.ssim(a, b) - jmetrics.ssim(a, b)) <= 1e-10
    assert abs(metrics.ssim(a[..., 0], b[..., 0], multichannel=False)
               - jmetrics.ssim(a[..., 0], b[..., 0],
                               multichannel=False)) <= 1e-10
    assert metrics.ssim(a, a) == pytest.approx(1.0)
