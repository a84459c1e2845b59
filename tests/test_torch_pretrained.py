"""The ``encoder.pretrained`` graft of the port against the JAX package's
``PixelNeRF._maybe_load_pretrained`` on the CPU: a synthetic
torchvision-named ``resnet18_imagenet.npz`` (seeded arrays, written by
``nn.pretrained.save_backbone_npz``) found through PNY_PRETRAINED_DIR;
the missing npz (a warning, or an error under PNY_PRETRAINED_STRICT);
the ELAN backbone, which has no pretrained source; and
``load_pretrained = False``, which skips the graft."""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import scene, small_flagship, small_yolo


def _npz(path):
    """A full torchvision resnet18 state_dict of seeded arrays (every
    stage, fc and the integer counters, which the writer drops)."""
    from pixelnerf_yolo_torch.nn.pretrained import save_backbone_npz
    from pixelnerf_yolo_torch.nn.resnet import ResNetFeatures

    rng = np.random.default_rng(11)
    sd = {}
    for k, t in ResNetFeatures("resnet18", num_layers=5).state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = t
        elif "running_var" in k or (k.endswith(".weight") and t.ndim == 1):
            sd[k] = rng.uniform(0.5, 1.5, t.shape).astype(np.float32)
        else:
            sd[k] = (0.1 * rng.normal(size=t.shape)).astype(np.float32)
    sd["fc.weight"] = rng.normal(size=(1000, 512)).astype(np.float32)
    sd["fc.bias"] = rng.normal(size=(1000,)).astype(np.float32)
    save_backbone_npz(sd, str(path / "resnet18_imagenet.npz"))
    return sd


@pytest.fixture
def pretrained_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("PNY_PRETRAINED_DIR", str(tmp_path))
    monkeypatch.delenv("PNY_PRETRAINED_STRICT", raising=False)
    return tmp_path


def _pretrained_conf():
    conf = small_flagship()
    conf.put("model.encoder.pretrained", True)
    return conf.get_config("model")


def test_graft_matches_jax(pretrained_dir):
    """Both packages graft the same npz: every tensor of the port's
    truncated trunk (2 layers) comes from it, and the encoders' latents
    agree to 2e-5 x max(1, max|latent|)."""
    from pixelnerf_yolo_tpu.models import make_model as jax_model
    from pixelnerf_yolo_torch.models import make_model
    from pixelnerf_yolo_torch.nn.pretrained import pretrained_path

    sd = _npz(pretrained_dir)
    assert pretrained_path("resnet18") == str(
        pretrained_dir / "resnet18_imagenet.npz")
    conf = _pretrained_conf()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        model = make_model(conf, device="cpu")
    enc = model.encoder.model.state_dict()
    grafted = [k for k in enc if not k.endswith("num_batches_tracked")]
    # the stem's conv and BatchNorm (1 + 4 tensors), layer1's two blocks
    # (2 x (1 + 4) each)
    assert len(grafted) == 5 + 2 * 10
    for k in grafted:
        np.testing.assert_array_equal(enc[k].numpy(), sd[k], err_msg=k)

    images, poses, focal = scene(ns=2)
    jm = jax_model(conf)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(images[0]),
                load_pretrained=True)
    ref = jm.encode(v, jnp.asarray(images), jnp.asarray(poses),
                    jnp.asarray(focal)).latent_flat
    with torch.no_grad():
        got = model.encode(images, poses, focal).latent_flat
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))  # ~14 with these weights
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-5 * scale)


def test_load_pretrained_false_skips_the_graft(pretrained_dir):
    from pixelnerf_yolo_torch.models import make_model

    _npz(pretrained_dir)
    skipped = make_model(_pretrained_conf(), device="cpu",
                         load_pretrained=False)
    random = make_model(small_flagship().get_config("model"), device="cpu")
    grafted = make_model(_pretrained_conf(), device="cpu")
    for k, t in skipped.state_dict().items():
        assert torch.equal(t, random.state_dict()[k]), k
    assert not torch.equal(grafted.state_dict()["encoder.model.conv1.weight"],
                           random.state_dict()["encoder.model.conv1.weight"])


def test_missing_npz_warns_or_raises(pretrained_dir, monkeypatch):
    from pixelnerf_yolo_torch.models import make_model

    with pytest.warns(UserWarning, match="No pretrained weights for "
                      "'resnet18'"):
        a = make_model(_pretrained_conf(), device="cpu")
    b = make_model(small_flagship().get_config("model"), device="cpu")
    for k, t in a.state_dict().items():
        assert torch.equal(t, b.state_dict()[k]), k
    monkeypatch.setenv("PNY_PRETRAINED_STRICT", "1")
    with pytest.raises(FileNotFoundError, match="resnet18_imagenet.npz"):
        make_model(_pretrained_conf(), device="cpu")


def test_elan_is_skipped(pretrained_dir, monkeypatch, capsys):
    """The ELAN backbone has no pretrained source: printed, no warning, no
    error even under PNY_PRETRAINED_STRICT."""
    from pixelnerf_yolo_torch.models import make_model

    monkeypatch.setenv("PNY_PRETRAINED_STRICT", "1")
    conf = small_yolo().get_config("model")
    conf.put("encoder.pretrained", True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        make_model(conf, device="cpu")
    assert "encoder init: random (no pretrained source" in \
        capsys.readouterr().out


def test_graft_shape_mismatch_raises():
    from pixelnerf_yolo_torch.nn.pretrained import graft
    from pixelnerf_yolo_torch.nn.resnet import ResNetFeatures

    trunk = ResNetFeatures("resnet18", num_layers=2)
    with pytest.raises(ValueError, match="conv1.weight"):
        graft(trunk, {"conv1.weight": np.zeros((64, 3, 3, 3), np.float32)})
    assert graft(trunk, {"layer4.0.conv1.weight": np.zeros(1)}) == 0
