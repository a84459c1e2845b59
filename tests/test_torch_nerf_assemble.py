"""The NeRF trainer's batch assembly (``PixelNeRFTrainer._assemble``),
which builds rays and colours only for the pixels it draws, against the
whole-image assembly it replaced (every view's rays from ``gen_rays_np``,
then the drawn rows), written out here: from Generators seeded alike, the
two give the same arrays bitwise and leave their Generators at the same
state.  Also ``gen_rays_at_np`` against ``gen_rays_np``'s rows, and the
``assemble_rays`` counter of one recorded NeRF train step."""

import types

import numpy as np
import pytest

from pixelnerf_yolo_torch.train.nerf_trainer import PixelNeRFTrainer
from pixelnerf_yolo_torch.utils import camera, profiling
from pixelnerf_yolo_torch.utils.sampling import bbox_sample

SB, NV, H, W = 2, 5, 12, 20  # H != W, so a row and a column cannot swap
R = 37
NEAR, FAR = 0.8, 1.8


def _poses(rng, n):
    """(n, 4, 4) camera-to-world poses with random rotations."""
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    poses[:, :3, :3] = q
    poses[:, :3, 3] = rng.normal(size=(n, 3)) * 2.0
    return poses


def _data(rng, intrinsics):
    cmin = rng.integers(0, W // 2, size=(SB, NV))
    rmin = rng.integers(0, H // 2, size=(SB, NV))
    bbox = np.stack([cmin, rmin, cmin + rng.integers(0, W // 2, (SB, NV)),
                     rmin + rng.integers(0, H // 2, (SB, NV))], -1)
    data = {
        "images": rng.uniform(-1, 1, (SB, NV, 3, H, W)).astype(np.float32),
        "poses": _poses(rng, SB * NV).reshape(SB, NV, 4, 4),
        "bbox": bbox.astype(np.float32),
    }
    if intrinsics == "fxfy_c":
        data["focal"] = rng.uniform(10, 30, (SB, 2)).astype(np.float32)
        data["c"] = rng.uniform(4, 12, (SB, 2)).astype(np.float32)
    else:
        data["focal"] = rng.uniform(10, 30, SB).astype(np.float32)
    return data


def _whole_image_assemble(rng, data, nviews, use_bbox, multiple):
    """The assembly before it built only the drawn pixels: every view's
    rays and colours, then the drawn rows."""
    all_images = np.asarray(data["images"])
    all_poses = np.asarray(data["poses"])
    all_focals = np.asarray(data["focal"])
    all_c = np.asarray(data["c"]) if "c" in data else None
    all_bboxes = data["bbox"] if use_bbox else None
    curr_nviews = nviews[int(rng.integers(0, len(nviews)))]
    image_ord = np.empty((SB, curr_nviews), dtype=np.int64)
    all_rgb_gt, all_rays = [], []
    for obj_idx in range(SB):
        c = all_c[obj_idx] if all_c is not None else None
        image_ord[obj_idx] = rng.choice(NV, curr_nviews, replace=False)
        images_0to1 = all_images[obj_idx] * 0.5 + 0.5
        cam_rays = camera.gen_rays_np(all_poses[obj_idx], W, H,
                                      all_focals[obj_idx], NEAR, FAR, c=c)
        rgb_gt_all = images_0to1.transpose(0, 2, 3, 1).reshape(-1, 3)
        if all_bboxes is not None:
            pix = bbox_sample(np.asarray(all_bboxes[obj_idx]), R, rng=rng)
            pix_inds = pix[:, 0] * H * W + pix[:, 1] * W + pix[:, 2]
        else:
            pix_inds = rng.integers(0, NV * H * W, size=R)
        all_rgb_gt.append(rgb_gt_all[pix_inds])
        all_rays.append(cam_rays.reshape(-1, 8)[pix_inds])
    rays, rgb_gt = np.stack(all_rays), np.stack(all_rgb_gt)
    src_images = all_images[np.arange(SB)[:, None], image_ord]
    src_poses = all_poses[np.arange(SB)[:, None], image_ord]
    w = np.ones(rays.shape[:2], dtype=np.float32)
    pad_r = (-rays.shape[1]) % multiple
    if pad_r:
        idx = np.arange(pad_r) % rays.shape[1]
        rays = np.concatenate([rays, rays[:, idx]], axis=1)
        rgb_gt = np.concatenate([rgb_gt, rgb_gt[:, idx]], axis=1)
        w = np.concatenate([w, np.zeros((SB, pad_r), np.float32)], axis=1)
    return src_images, src_poses, all_focals, all_c, rays, rgb_gt, w


def _bitwise_equal(a, b):
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


# sampling: "bbox" (a train step before --no_bbox_step), "uniform" (a
# train step after it), "eval" (an eval step, which never samples in
# the bounding boxes)
@pytest.mark.parametrize("sampling", ["bbox", "uniform", "eval"])
@pytest.mark.parametrize("ns", [1, 2])
@pytest.mark.parametrize("intrinsics", ["scalar", "fxfy_c"])
@pytest.mark.parametrize("multiple", [1, 4])
def test_assemble_matches_whole_image(sampling, ns, intrinsics, multiple):
    data = _data(np.random.default_rng(5), intrinsics)
    seed = 2 ** 33 + 17
    nviews = [ns, 3] if ns == 2 else [ns]
    trainer = types.SimpleNamespace(
        use_bbox=True, nviews=nviews, z_near=NEAR, z_far=FAR,
        args=types.SimpleNamespace(
            no_bbox_step=0 if sampling == "uniform" else 10,
            ray_batch_size=R),
        _rng=np.random.default_rng(seed),
        _ray_multiple=lambda n_scenes: multiple)
    got = PixelNeRFTrainer._assemble(trainer, data, sampling != "eval", 3)
    old_rng = np.random.default_rng(seed)
    want = _whole_image_assemble(old_rng, data, nviews,
                                 sampling == "bbox", multiple)
    names = ("src_images", "src_poses", "focal", "c", "rays", "rgb_gt", "w")
    for name, g, w in zip(names, got, want):
        assert _bitwise_equal(g, w), name
    assert got[4].shape == (SB, R + (-R) % multiple, 8)
    assert trainer._rng.integers(0, 2 ** 62) == old_rng.integers(0, 2 ** 62)


@pytest.mark.parametrize("focal,c", [
    (np.float32(17.5), None),
    (np.asarray([17.5], np.float32), None),
    (np.asarray([17.5, 21.0], np.float32),
     np.asarray([9.25, 5.5], np.float32)),
    (np.float32(17.5), np.float32(7.0)),
])
def test_gen_rays_at_np_matches_rows(focal, c):
    rng = np.random.default_rng(11)
    poses = _poses(rng, NV)
    full = camera.gen_rays_np(poses, W, H, focal, NEAR, FAR, c=c)
    n = 4096
    view, row, col = (rng.integers(0, NV, n), rng.integers(0, H, n),
                      rng.integers(0, W, n))
    got = camera.gen_rays_at_np(poses, view, row, col, W, H, focal, NEAR,
                                FAR, c=c)
    assert _bitwise_equal(got, full[view, row, col])


def test_train_step_counts_the_rays_it_builds(tmp_path):
    from pixelnerf_yolo_torch.config.hocon import parse_string
    from pixelnerf_yolo_torch.data import DataLoader, get_split_dataset
    from pixelnerf_yolo_torch.models import make_model
    from pixelnerf_yolo_torch.render import make_renderer
    from pixelnerf_yolo_torch.train import make_trainer
    from synth_data import make_srn_dataset
    from torch_parity import nerf_train_conf, train_args

    root = str(tmp_path / "data" / "cars")
    for stage in ("train", "val", "test"):
        make_srn_dataset(root, stage=stage, n_objs=2, n_views=3, img_size=16)
    conf = nerf_train_conf(parse_string, "false")
    dset, val_dset = get_split_dataset("srn", root, image_size=(16, 16))[:2]
    rays = 8
    trainer = make_trainer(
        train_args(tmp_path, "assemble", nviews="1", ray_batch_size=rays,
                   batch_size=2),
        conf, dset, val_dset,
        make_model(conf.get_config("model"), device="cpu", seed=0),
        make_renderer(conf, device="cpu"), [1], device="cpu")
    batch = next(iter(DataLoader(dset, batch_size=2)))
    trainer.train_step(batch, 0)  # recording off: counts nothing
    with profiling.recording():
        trainer.train_step(batch, 1)
        assert profiling.counters().get("assemble_rays") == 2 * rays
        assert "batch_assemble" in {r.name for r in profiling.records()}
