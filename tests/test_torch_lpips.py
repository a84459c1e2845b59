"""The port's LPIPS (pixelnerf_yolo_torch/nn/lpips.py) against the JAX
package's lpips_distance with the same random VGG16 and head weights (no
lpips_vgg.npz ships), its npz round trip and its missing-file message."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pixelnerf_yolo_tpu.nn import lpips as jlpips
from pixelnerf_yolo_torch.nn import lpips as tlpips
from test_lpips import synth_weights

TOL = 1e-5


@pytest.fixture(scope="module")
def weights():
    return synth_weights(np.random.default_rng(0))


def _images(seed, n=2, size=32):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, size=(n, 3, size, size)).astype(np.float32)


@pytest.mark.parametrize("size", [16, 32])
def test_lpips_distance_matches_jax(weights, size):
    a, b = _images(1, size=size), _images(2, size=size)
    jp = jlpips.port_lpips_state_dict(*weights)
    tp = tlpips.port_lpips_state_dict(*weights)
    want = np.asarray(jlpips.lpips_distance(jp, jnp.asarray(a),
                                            jnp.asarray(b)))
    got = tlpips.lpips_distance(tp, torch.from_numpy(a),
                                torch.from_numpy(b)).numpy()
    assert got.shape == (2,)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_identity_is_zero(weights):
    a = torch.from_numpy(_images(3))
    tp = tlpips.port_lpips_state_dict(*weights)
    assert tlpips.lpips_distance(tp, a, a).abs().max().item() == 0.0


def _write_npz(path, weights):
    vgg_sd, lin_sd = weights
    np.savez(path, **vgg_sd, **lin_sd)


def test_npz_round_trip(weights, tmp_path, monkeypatch):
    monkeypatch.setenv("PNY_PRETRAINED_DIR", str(tmp_path))
    _write_npz(tmp_path / "lpips_vgg.npz", weights)
    assert tlpips.lpips_npz_path() == str(tmp_path / "lpips_vgg.npz")
    params, path = tlpips.load_lpips()
    jparams, jpath = jlpips.load_lpips()
    assert path == jpath
    for k, v in jparams.items():
        for name, arr in v.items():
            np.testing.assert_array_equal(params[k][name].numpy(), arr)
    a, b = _images(4), _images(5)
    np.testing.assert_allclose(
        tlpips.lpips_distance(params, torch.from_numpy(a),
                              torch.from_numpy(b)).numpy(),
        np.asarray(jlpips.lpips_distance(jparams, jnp.asarray(a),
                                         jnp.asarray(b))),
        rtol=TOL, atol=TOL)


def test_missing_npz_message(tmp_path, monkeypatch):
    monkeypatch.setenv("PNY_PRETRAINED_DIR", str(tmp_path))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    with pytest.raises(FileNotFoundError) as port_err:
        tlpips.load_lpips()
    with pytest.raises(FileNotFoundError) as jax_err:
        jlpips.load_lpips()
    head = "No lpips_vgg.npz found. Port the weights once with "
    assert str(port_err.value).startswith(head)
    # the same words up to the search path, which names each package's
    # own cache directory
    cut = str(jax_err.value).index(" one of: ")
    assert str(port_err.value)[:cut] == str(jax_err.value)[:cut]
    assert str(tmp_path) in str(port_err.value)


def test_package_fallback(tmp_path, monkeypatch, capsys):
    """Without the npz, calc_metrics falls back to the ``lpips`` package,
    built on the requested device; a missing package skips LPIPS with the
    npz's message, and any other failure of the package is raised."""
    import sys
    import types

    from pixelnerf_yolo_torch.eval.calc_metrics import make_lpips

    monkeypatch.setenv("PNY_PRETRAINED_DIR", str(tmp_path))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    moved = []

    class FakeLPIPS(torch.nn.Module):
        def __init__(self, net):
            super().__init__()
            assert net == "vgg"

        def to(self, device):
            moved.append(device)
            return self

        def forward(self, a, b):
            return (a - b).abs().mean()

    monkeypatch.setitem(sys.modules, "lpips",
                        types.SimpleNamespace(LPIPS=FakeLPIPS))
    fn = make_lpips("cpu")
    img = np.zeros((4, 4, 3), np.float32)
    assert moved == ["cpu"]
    assert fn(img, img + 0.25) == pytest.approx(0.5)

    def broken(net):
        raise RuntimeError("corrupt weights")

    monkeypatch.setitem(sys.modules, "lpips",
                        types.SimpleNamespace(LPIPS=broken))
    with pytest.raises(RuntimeError, match="corrupt weights"):
        make_lpips("cpu")

    monkeypatch.setitem(sys.modules, "lpips", None)
    capsys.readouterr()
    assert make_lpips("cpu") is None
    out = capsys.readouterr().out
    assert out.startswith("LPIPS unavailable (reported as 0.0): No "
                          "lpips_vgg.npz found.")
