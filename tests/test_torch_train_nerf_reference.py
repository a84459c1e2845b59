"""The port's pixelNeRF training step (``PixelNeRFTrainer.train_step``)
against the benchmark's plain reference step
(``benchmark/reference/train_nerf.py``) on the CPU at a small width,
through the ``srn_train`` cell's driver: its set-up takes the trainer
through three steps on seeded objects, and its check replays them in the
reference (the trainer's view and pixel draws from the same generator
seed, the render's draws given to both).  The driver runs without the
harness, which refuses a process that has loaded JAX."""

import copy

import pytest
import torch


def small_cell():
    from benchmark import harness

    cell = harness.load_cell("srn_train")
    cfg = copy.deepcopy(cell.config)
    cfg["scene"].update({"image_size": 32, "focal": 32.8125})
    cfg["conf"]["model"]["compute_dtype"] = "float32"
    for mlp in ("mlp_coarse", "mlp_fine"):
        cfg["conf"]["model"][mlp]["d_hidden"] = 32
    cfg["conf"]["renderer"].update({"n_coarse": 16, "n_fine": 8,
                                    "n_fine_depth": 4})
    cell.config = cfg
    cell.traffic = dict(cell.traffic, objects=3, views=4, sb=2,
                        rays_per_object=16, trace={"skip": 0, "units": 1})
    return cell


@pytest.mark.parametrize("seed", [7, 2 ** 33 + 5])
def test_nerf_step_against_reference(seed):
    from benchmark.drivers.train_nerf import Driver

    cell = small_cell()
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        drv = Driver(cell.config, cell.traffic, seed, "cpu")
        drv.setup()
        nums = drv.numbers()
    finally:
        torch.set_num_threads(n)
    for name, limit in cell.limits["limits"].items():
        assert nums[name] <= limit, name
    # the first step from the same weights, batch and draws: float32
    # summation order apart
    assert nums["loss1_gap"] < 1e-5
    assert nums["grad_gap"] < 1e-3
    assert nums["grad_exc"] == 0.0
    assert nums["delta_gap_median"] < 1e-3
    assert nums["leaves_left_out"] == 0
