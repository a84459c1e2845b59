"""Multi-scale YOLO in the port against the JAX package on the CPU: a 2-
and a 3-scale model and render, one YOLOTrainer update, the box lists of
vis_step with per-scale thresholds and cross-scale suppression, and
map_step, metric_and_map_step and calibrate_scales.  The same weights
(``convert.from_jax_variables``), the same batch and view choice, and the
same coarse draws: the JAX trainer's key chain (PRNGKey(seed + 2), one
split per render) feeds the port's renders (``_JaxKeyed``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pixelnerf_yolo_torch.convert import from_jax_variables
from synth_data import make_yolo_dataset
from torch_parity import (jax_yolo_draws, jax_yolo_trainer, jax_yolo_update,
                          perturbed_variables, port_model,
                          port_yolo_trainer, small_yolo, to_np, yolo_scene)

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
BOX_TOL = 1e-5  # decoded box values; the class and the count are exact
MAP_TOL = 1e-6

SCALES = {
    2: {"model.mlp_coarse.num_scales": 2, "yolo.cell_sizes": [32, 16]},
    3: {"model.mlp_coarse.num_scales": 3, "yolo.cell_sizes": [32, 16, 8],
        "yolo.cross_scale_nms_iou": 0.35,
        "yolo.nms_threshold_per_scale": [0.5, 0.6]},
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multiscale")
    return make_yolo_dataset(str(tmp / "data"), n_scenes=2, n_views=4,
                             img_size=64, randomize=True, seed=3)


def _loader(root, conf_puts, split):
    from pixelnerf_yolo_torch.config.hocon import parse_string
    from pixelnerf_yolo_torch.data import DataLoader, YOLODataset
    from torch_parity import yolo_train_conf

    conf = yolo_train_conf(parse_string, "true", puts=conf_puts)
    dset = YOLODataset(root, stage=split, z_near=1, z_far=13.0, conf=conf)
    return DataLoader(dset, batch_size=1, shuffle=False)


class _JaxKeyed:
    """The port trainer's renderer with the coarse draws the JAX trainer's
    renders take: its key PRNGKey(seed + 2), split once per render."""

    def __init__(self, renderer, seed=0):
        self.renderer = renderer
        self.key = jax.random.PRNGKey(seed + 2)

    def __call__(self, model, cond, rays, generator=None, u=None):
        # the renderer's signature; this wrapper supplies the draws itself
        assert u is None
        self.key, sub = jax.random.split(self.key)
        n = rays.reshape(-1, 8).shape[0]
        u = jax_yolo_draws(sub, n, self.renderer.n_coarse)
        return self.renderer(model, cond, rays, u=torch.from_numpy(u))

    def __getattr__(self, name):
        return getattr(self.renderer, name)


def _trainers(root, tmp_path, n_scales, fused="true"):
    jtr, v = jax_yolo_trainer(root, tmp_path, fused, puts=SCALES[n_scales])
    ttr = port_yolo_trainer(root, tmp_path, v, fused, puts=SCALES[n_scales])
    ttr.renderer = _JaxKeyed(ttr.renderer)
    return jtr, ttr, v


@pytest.mark.parametrize("n_scales", [2, 3])
def test_multiscale_model_renders_like_jax(n_scales):
    """A multi-scale model builds (d_out = 7 x anchors, the same field at
    every scale) and its YoloRenderer call matches JAX's."""
    from pixelnerf_yolo_tpu.models import make_model as jax_model
    from pixelnerf_yolo_tpu.render import make_renderer as jax_renderer
    from pixelnerf_yolo_tpu.utils.camera import gen_rays_yolo
    from pixelnerf_yolo_torch.render import make_renderer

    conf = small_yolo()
    conf.put("model.mlp_coarse.num_scales", n_scales)
    jm = jax_model(conf.get_config("model"))
    images, poses, focal, c, target = yolo_scene(ns=3)
    v = perturbed_variables(jm, images[0])
    tm = port_model(conf, v)
    assert tm.d_out == jm.d_out == 21
    jr, tr = jax_renderer(conf), make_renderer(conf, device="cpu")
    rays = np.array(gen_rays_yolo(jnp.asarray(target), 4, 4,
                                  jnp.asarray(focal[0] / 16),
                                  jnp.asarray(c[0] / 16), 1.0, 3.0))
    rays = rays.reshape(-1, 8)
    key = jax.random.PRNGKey(7)
    vs = jax.tree.map(jnp.asarray, v)
    jcond = jm.encode(vs, jnp.asarray(images), jnp.asarray(poses),
                      jnp.asarray(focal), c=jnp.asarray(c))
    want = np.asarray(jr(jm, vs, jcond, jnp.asarray(rays), key))
    with torch.no_grad():
        tcond = tm.encode(images, poses, focal, c=c)
    got = tr(tm, tcond, rays, u=torch.from_numpy(
        jax_yolo_draws(key, len(rays), jr.n_coarse)))
    np.testing.assert_allclose(to_np(got), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_scales,fused", [(2, "false"), (3, "true")])
def test_multiscale_update_matches_jax(tmp_path, root, n_scales, fused):
    """f32: the 5 reported losses and every parameter gradient of one
    update; every chunk belongs to one scale and takes its anchors."""
    jtr, ttr, v = _trainers(root, tmp_path, n_scales, fused)
    batch = next(iter(_loader(root, SCALES[n_scales], "val")))
    ref_losses, ref_grads, _, u = jax_yolo_update(jtr, batch)
    inputs = ttr._assemble(batch)
    ttr._rng = np.random.default_rng(1)  # replay the same view choice
    assert len(set(map(tuple, inputs[6].reshape(len(inputs[6]), -1)))) \
        == n_scales
    losses = ttr.train_step(batch, u=torch.from_numpy(u))
    got = np.array([float(losses[k]) for k in
                    ("t", "box_loss", "object_loss", "no_object_loss",
                     "class_loss")])
    np.testing.assert_allclose(got, ref_losses, rtol=LOSS_RTOL)
    ref_g = from_jax_variables({"params": ref_grads,
                                "batch_stats": v["batch_stats"]})
    for name, p in ttr.model.named_parameters():
        r = ref_g[name].numpy()
        scale = np.abs(r).max()
        assert np.abs(p.grad.numpy() - r).max() <= GRAD_TOL * scale, name


def _same_boxes(got, want):
    got = np.asarray(got, np.float32).reshape(-1, 6)
    want = np.asarray(want, np.float32).reshape(-1, 6)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got, want, rtol=BOX_TOL, atol=BOX_TOL)


@pytest.mark.parametrize("n_scales", [2, 3])
def test_vis_step_boxes_match_jax(tmp_path, root, n_scales):
    """only_bbox=True (per-scale thresholds, cross-scale suppression, the
    scales joined) and "per_scale" (the raw lists): the same boxes."""
    jtr, ttr, _ = _trainers(root, tmp_path, n_scales)
    data = next(iter(_loader(root, SCALES[n_scales], "test")))
    srcs = np.array([0, 2, 3])
    for only in (True, "per_scale"):
        jgt, jpred = jtr.vis_step(data, idx=0, srcs=srcs, dest=2,
                                  only_bbox=only)
        tgt, tpred = ttr.vis_step(data, idx=0, srcs=srcs, dest=2,
                                  only_bbox=only)
        _same_boxes(tgt, jgt)
        if only == "per_scale":
            assert len(tpred) == len(jpred) == n_scales
            for a, b in zip(tpred, jpred):
                _same_boxes(a, b)
        else:
            _same_boxes(tpred, jpred)
    if n_scales == 3:
        assert ttr.nms_threshold_per_scale == jtr.nms_threshold_per_scale \
            == [0.5, 0.6, 0.0]
        assert ttr.cross_scale_nms_iou == jtr.cross_scale_nms_iou == 0.35


def _same_map(got, want):
    assert abs(got[0] - want[0]) <= MAP_TOL
    assert set(got[1]) == set(want[1])
    for k, ap in want[1].items():
        assert abs(got[1][k] - ap) <= MAP_TOL, k


@pytest.mark.parametrize("n_scales", [2, 3])
def test_metrics_match_jax(tmp_path, root, n_scales):
    """metric_and_map_step, map_step and calibrate_scales: the same
    TP/FP/FN, P/R/F1 exactly, mAP within 1e-6; calibrate_scales at the
    single combination nms_threshold equals metric_step."""
    jtr, ttr, _ = _trainers(root, tmp_path, n_scales)
    jtr.use_host_nms = ttr.use_host_nms = False
    loader = _loader(root, SCALES[n_scales], "test")
    (jf1, jmap) = jtr.metric_and_map_step(loader)
    (tf1, tmap) = ttr.metric_and_map_step(loader)
    assert tf1 == jf1
    _same_map(tmap, jmap)
    _same_map(ttr.map_step(loader), jtr.map_step(loader))

    grid = [0.45, 0.7]
    jres, jbest = jtr.calibrate_scales(loader, grid)
    tres, tbest = ttr.calibrate_scales(loader, grid)
    assert len(tres) == len(jres) == len(grid) ** n_scales
    for t, j in zip(tres + [tbest], jres + [jbest]):
        assert tuple(t["taus"]) == tuple(j["taus"])
        for k in ("tp", "fp", "fn", "precision", "recall", "f1"):
            assert t[k] == j[k], k
        _same_map((t["map50"], t["per_class"]), (j["map50"], j["per_class"]))

    # one combination at the global threshold is metric_step on the host,
    # on the same renders
    ttr.use_host_nms = True
    ttr.nms_threshold_per_scale = None
    ttr.renderer.key = jax.random.PRNGKey(2)
    res, _ = ttr.calibrate_scales(loader, [ttr.nms_threshold])
    ttr.renderer.key = jax.random.PRNGKey(2)
    p, r, f1 = ttr.metric_step(loader)
    assert (res[0]["precision"], res[0]["recall"], res[0]["f1"]) == (p, r, f1)


def test_train_yolo_3scale_conf_is_the_recipe():
    """config/flagship.py::train_yolo_3scale_conf sets what
    conf/exp/yolo_3scale.conf sets over yolo.conf (read by the port's
    parser with its includes)."""
    from pixelnerf_yolo_torch.config.flagship import (train_yolo_3scale_conf,
                                                      train_yolo_conf)
    from pixelnerf_yolo_torch.config.hocon import parse_file
    from pixelnerf_yolo_torch.models import make_model

    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    recipe = parse_file(os.path.join(repo, "conf", "exp", "yolo_3scale.conf"))
    conf = train_yolo_3scale_conf("bfloat16")
    for key in ("model.mlp_coarse.num_scales", "model.remat",
                "model.compute_dtype", "renderer.aggregation",
                "yolo.cell_sizes", "yolo.cross_scale_nms_iou",
                "yolo.anchors"):
        assert conf.get(key) == recipe.get(key), key
    assert train_yolo_conf().get("yolo.ray_batch_size") == 1024
    calibrated = parse_file(os.path.join(
        repo, "conf", "exp", "yolo_3scale_calibrated.conf"))
    for c in (recipe, calibrated):  # both build through the port
        model = make_model(c.get_config("model"), device="cpu",
                           load_pretrained=False)
        assert model.remat and model.d_out == 21
