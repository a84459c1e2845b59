"""The yardstick's counts against hand arithmetic."""

import pytest

from benchmark import flops

# the SRN cars field: d_in 3 + 36 + 3, a 512-d latent, 5 x 512 blocks,
# combine at 3, rgb + sigma
W = {"d_in": 42, "d_latent": 512, "H": 512, "n_pre": 3, "n_post": 2,
     "d_out": 4}
SRN = {"model": {"code": {"num_freqs": 6},
                 "encoder": {"backbone": "resnet34", "num_layers": 4},
                 "mlp_coarse": {"d_hidden": 512, "combine_layer": 3,
                                "n_blocks": 5, "d_out": 4},
                 "mlp_fine": {"type": "resnet"}}}


def test_widths():
    assert flops.field_widths(SRN) == W


def test_full_pe_by_hand():
    rows = 1000
    macs = 42 * 512 + 3 * (512 * 512 + 2 * 512 * 512) + 2 * 2 * 512 * 512 \
        + 512 * 4
    weights_bf16 = 2 * macs
    biases_f32 = 4 * (512 + 3 * 3 * 512 + 2 * 2 * 512 + 4)
    io = rows * 6 * 4 + rows * 512 * 2 + rows * 4 * 4
    assert flops.kernel_work("full_pe", rows, W) == (
        2 * rows * macs, io + weights_bf16 + biases_f32)
    # 1.098 GFLOP a ray of 64 + 96 samples
    per_ray = 160 * 2 * macs
    assert per_ray == pytest.approx(1.098e9, rel=1e-3)


def test_pre_combine_pe_by_hand():
    rows = 3 * 777
    w = dict(W, d_latent=1792, d_out=21)
    macs = 42 * 512 + 3 * (1792 * 512 + 2 * 512 * 512)
    byts = (rows * 6 * 4 + rows * 1792 * 2 + 2 * macs
            + 4 * (512 + 3 * 3 * 512) + rows * 512 * 2)
    assert flops.kernel_work("pre_combine_pe", rows, w) == (2 * rows * macs,
                                                           byts)
    post = 2 * 2 * 512 * 512 + 512 * 21
    assert flops.kernel_work("post_combine", 777, w)[0] == 2 * 777 * post


def test_roofline_bound():
    t, bound = flops.roofline_seconds(989e12, 1.0)
    assert (t, bound) == (1.0, "compute")
    t, bound = flops.roofline_seconds(1.0, 3.35e12)
    assert (t, bound) == (1.0, "memory")


def test_reference_flops_counts_the_field_once_a_row():
    """FlopCounterMode over the reference on the meta device: the field's
    products on each row (the coarse MLP at NS views before the combine,
    a row a ray after it) and the fine MLP on its rows."""
    conf = dict(SRN)
    conf["model"] = dict(SRN["model"], code={"num_freqs": 6,
                                             "freq_factor": 1.5})
    f = flops.reference_flops(conf, (1, 3, 32, 32), 100, 1, 50)
    macs = 42 * 512 + 3 * 3 * 512 * 512 + 2 * 2 * 512 * 512 + 512 * 4
    assert f["field"] == 2 * 150 * macs
    assert f["encoder"] > 0
    f3 = flops.reference_flops(conf, (3, 3, 32, 32), 300, 3)
    pre = 42 * 512 + 3 * 3 * 512 * 512
    post = 2 * 2 * 512 * 512 + 512 * 4
    assert f3["field"] == 2 * (300 * pre + 100 * post)
    assert f3["encoder"] == 3 * f["encoder"]
