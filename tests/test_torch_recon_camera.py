"""The port's mesh reconstruction (pixelnerf_yolo_torch/utils/recon.py) and
the pose helpers of utils/camera.py against the JAX package's."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import pixelnerf_yolo_tpu.utils.camera as jcam
import pixelnerf_yolo_tpu.utils.recon as jrecon
import pixelnerf_yolo_torch.utils.camera as tcam
import pixelnerf_yolo_torch.utils.recon as trecon
from pixelnerf_yolo_tpu.models import make_model as jmake_model
from torch_parity import perturbed_variables, port_model, scene, small_flagship

TOL = 1e-6


def _sphere_grid(n=12, r=0.6):
    ax = np.linspace(-1, 1, n)
    z, y, x = np.meshgrid(ax, ax, ax, indexing="ij")
    return 20.0 * (r - np.sqrt(x * x + y * y + z * z))


def test_marching_cubes_identical():
    grid = _sphere_grid()
    tv, tt = trecon.marching_cubes(grid, iso_value=0.0)
    jv, jt = jrecon.marching_cubes(grid, iso_value=0.0)
    assert len(tt) > 0
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tt, jt)


def test_save_obj_identical(tmp_path):
    v, t = jrecon.marching_cubes(_sphere_grid(8), iso_value=0.0)
    rgb = np.abs(np.sin(v))
    for colour in (None, rgb):
        trecon.save_obj(v, t, str(tmp_path / "t.obj"), vert_rgb=colour)
        jrecon.save_obj(v, t, str(tmp_path / "j.obj"), vert_rgb=colour)
        assert ((tmp_path / "t.obj").read_text()
                == (tmp_path / "j.obj").read_text())


def test_extract_mesh_from_model_matches_jax():
    conf = small_flagship()
    jm = jmake_model(conf.get_config("model"))
    images, poses, focal = scene(ns=1)
    v = perturbed_variables(jm, images[0])
    jv = jax.tree.map(jnp.asarray, v)
    jcond = jm.encode(jv, jnp.asarray(images), jnp.asarray(poses),
                      jnp.asarray(focal))
    bounds = ((-0.3, 0.3), (-0.3, 0.3), (-0.4, 0.2))
    tm = port_model(conf, v)
    with torch.no_grad():
        tcond = tm.encode(images, poses, focal)
    # the grid's median density, so that the surface crosses the grid
    pts = np.stack(np.meshgrid(*[np.linspace(lo, hi, 10) for lo, hi in bounds],
                               indexing="ij"), -1).reshape(1, -1, 3)
    dirs = np.zeros_like(pts)
    dirs[..., 2] = -1.0
    sigma = jm.forward(jv, jcond, jnp.asarray(pts, jnp.float32),
                       viewdirs=jnp.asarray(dirs, jnp.float32))[0, :, 3]
    iso = float(np.median(np.asarray(sigma)))
    want = jrecon.extract_mesh_from_model(jm, jv, jcond, bounds=bounds,
                                          resolution=10, iso_value=iso,
                                          chunk=300)
    got = trecon.extract_mesh_from_model(tm, tcond, bounds=bounds,
                                         resolution=10, iso_value=iso,
                                         chunk=300)
    assert len(want[1]) > 0
    assert got[1].shape == want[1].shape
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=1e-4)


@pytest.mark.parametrize("name", ["coord_from_blender", "coord_to_blender"])
def test_blender_frames(name):
    np.testing.assert_array_equal(getattr(tcam, name)(),
                                  np.asarray(getattr(jcam, name)()))


@pytest.mark.parametrize("fn,args", [
    ("trans_t", (0.7,)), ("rot_phi", (0.3,)), ("rot_theta", (-1.2,)),
    ("rot_kappa", (2.1,)), ("pose_spherical", (30.0, -10.0, 1.3)),
    ("pose_spherical2", (-75.0, 20.0, 2.0)),
])
def test_pose_constructors(fn, args):
    np.testing.assert_allclose(getattr(tcam, fn)(*args),
                               getattr(jcam, fn)(*args), atol=TOL)


def test_look_at():
    for origin in ([1.0, 0.5, 2.0], [-0.3, 1.2, -0.8]):
        np.testing.assert_allclose(
            tcam.look_at(origin, [0.1, 0.0, 0.2]),
            jcam.look_at(origin, [0.1, 0.0, 0.2]), atol=TOL)


@pytest.mark.parametrize("num_views", [5, 12])
def test_dtu_trajectory(num_views):
    got, want = tcam.dtu_trajectory(num_views), jcam.dtu_trajectory(num_views)
    assert got.shape == want.shape == (6 * max(num_views // 5, 1), 4, 4)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_quaternions():
    q = np.random.default_rng(0).normal(size=(7, 4)).astype(np.float32)
    R = tcam.quat_to_rot(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(R, np.asarray(jcam.quat_to_rot(jnp.asarray(q))),
                               atol=TOL)
    q_back = tcam.rot_to_quat(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(
        q_back, np.asarray(jcam.rot_to_quat(jnp.asarray(R))), atol=TOL)
