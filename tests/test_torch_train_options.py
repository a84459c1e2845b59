"""One f32 NeRF training update of the port against the JAX package's
``PixelNeRFTrainer`` for each model configuration of
tests/test_torch_model_options.py, on the CPU with the same weights,
batch, views and draws, the ReLU's derivative a ramp within 1e-3 of 0 in
both (``torch_parity.ramp_relu_grad``): here the ImplicitNet field, no
spatial encoder and the conv encoder; the global encoder in
tests/test_torch_train_global.py."""

import numpy as np
import pytest
import torch

from pixelnerf_yolo_torch.convert import from_jax_variables
from synth_data import make_srn_dataset
from test_torch_model_options import OPTIONS
from torch_parity import (jax_nerf_trainer, jax_nerf_update,  # noqa: F401
                          one_torch_thread, port_nerf_trainer,
                          ramp_relu_grad)

LOSS_RTOL = 1e-5  # each reported loss, relative
GRAD_TOL = 1e-4  # per tensor, relative to its max |gradient|
STAT_TOL = 1e-5  # BatchNorm running statistics, absolute


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from pixelnerf_yolo_torch.data import DataLoader, get_split_dataset
    from torch_parity import nerf_datasets

    tmp = tmp_path_factory.mktemp("options")
    root = str(tmp / "data" / "cars")
    for stage in ("train", "val", "test"):
        make_srn_dataset(root, stage=stage, n_objs=1, n_views=4, img_size=32)
    dset, _ = nerf_datasets(get_split_dataset, root)
    return root, next(iter(DataLoader(dset, batch_size=1)))


@pytest.mark.parametrize("option", ["implicit", "no_encoder", "conv"])
def test_update_matches_jax(tmp_path, monkeypatch, data, option):
    update_matches_jax(tmp_path, monkeypatch, data, option)


def update_matches_jax(tmp_path, monkeypatch, data, option):
    """One f32 update at NS=2 on the plain route: the 3 losses, every
    parameter gradient JAX gives a non-zero one (the port none or zero
    where JAX's is zero: the unused encoder of an encoder-free model), and
    every BatchNorm's running statistics, the global encoder's included.

    The global encoder's trunk is the exception: at this size its last
    map is 1x1, so its train-mode BatchNorms see 2 values a channel (the
    two source views), and the trunk's gradient is rounding noise in
    either package (each f32 evaluation differs from its f64 one by about
    10% of max|g|).  ``test_torch_encoders.py::
    test_global_encoder_train_gradient`` holds that
    gradient where it is defined; here its fc is held."""
    ramp_relu_grad(monkeypatch)
    root, batch = data
    puts = OPTIONS[option]
    jtr, v = jax_nerf_trainer(root, tmp_path, "false", 2, puts=puts,
                              ray_batch_size=16)
    ttr = port_nerf_trainer(root, tmp_path, v, "false", 2, puts=puts,
                            ray_batch_size=16)
    ref_losses, ref_grads, ref_vars, draws = jax_nerf_update(jtr, batch)
    losses = ttr.train_step(batch, 0, draws={
        k: torch.from_numpy(x) for k, x in draws.items()})
    for k, ref in ref_losses.items():
        np.testing.assert_allclose(float(losses[k]), ref, rtol=LOSS_RTOL,
                                   err_msg=k)
    ref_g = from_jax_variables({"params": ref_grads,
                                "batch_stats": v["batch_stats"]})
    ref_new = from_jax_variables(ref_vars)
    model = ttr.model
    checked = 0
    for name, p in model.named_parameters():
        r = ref_g[name].numpy()
        scale = np.abs(r).max()
        g = np.zeros_like(r) if p.grad is None else p.grad.numpy()
        if scale == 0:
            assert not np.any(g), name
            continue
        if name.startswith("global_encoder.model."):
            continue
        assert np.abs(g - r).max() <= GRAD_TOL * scale, name
        checked += 1
    assert checked > 0
    stats = {k: t for k, t in model.state_dict().items() if "running" in k}
    if option == "global":
        assert any(k.startswith("global_encoder.") for k in stats)
    for name, t in stats.items():
        np.testing.assert_allclose(t.numpy(), ref_new[name].numpy(),
                                   atol=STAT_TOL, rtol=0, err_msg=name)
