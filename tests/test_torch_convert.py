"""Checkpoint conversion into the port (pixelnerf_yolo_torch/convert.py):
the pure-Python flax msgpack reader against flax itself, and both CLI
routes (--jax_ckpt, --torch_ckpt) against the JAX package's own loaders
and forward, on the CPU at test size."""

import argparse

import numpy as np
import pytest

import flax.serialization
import jax
import jax.numpy as jnp
import torch

from pixelnerf_yolo_tpu.models import make_model as jmake_model
from pixelnerf_yolo_tpu.train.checkpoints import save_pytree
from pixelnerf_yolo_tpu.train.convert import convert_reference_state_dict
from pixelnerf_yolo_torch import convert
from pixelnerf_yolo_torch.config.flagship import flagship_conf_text
from pixelnerf_yolo_torch.models import make_model
from pixelnerf_yolo_torch.train import checkpoints
from torch_parity import (perturbed_variables, port_model, scene,
                          small_flagship, small_yolo, to_np, yolo_scene)

FWD_TOL = 2e-5  # module-level f32 forwards (PARITY.md)


def _flat(tree, prefix=""):
    """{path: leaf} of nested dicts."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _assert_same_tree(got, want):
    """Exact: the same paths, dtypes, shapes and bits (bf16 leaves are
    torch.bfloat16 tensors in got, ml_dtypes arrays in want)."""
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if isinstance(w, (np.ndarray, np.generic)) and w.dtype == jnp.bfloat16:
            assert isinstance(g, torch.Tensor) and g.dtype == torch.bfloat16, k
            assert tuple(g.shape) == np.shape(w), k
            np.testing.assert_array_equal(
                g.view(torch.int16).numpy().view(np.uint16),
                np.asarray(w).view(np.uint16), err_msg=k)
        elif isinstance(w, (np.ndarray, np.generic)):
            assert type(g) is type(w) and g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert type(g) is type(w) and g == w, k


def _nerf_side():
    conf = small_flagship()
    jm = jmake_model(conf.get_config("model"))
    images, _, _ = scene(ns=2)
    return conf, jm, perturbed_variables(jm, images[0])


@pytest.fixture(scope="module")
def nerf_side():
    return _nerf_side()


@pytest.mark.parametrize("mode", ["nerf", "yolo"])
def test_read_flax_msgpack_matches_flax(tmp_path, nerf_side, mode):
    """A model's variables written by the JAX package's save_pytree read
    back exactly as flax reads them, and load strictly into the port."""
    if mode == "nerf":
        conf, _, v = nerf_side
    else:
        conf = small_yolo()
        jm = jmake_model(conf.get_config("model"))
        v = perturbed_variables(jm, yolo_scene()[0][0])
    path = str(tmp_path / "pixel_nerf_latest")
    save_pytree(path, v)
    got = convert.read_flax_msgpack(path)
    with open(path, "rb") as f:
        data = f.read()
    _assert_same_tree(got, flax.serialization.msgpack_restore(data))
    _assert_same_tree(got, flax.serialization.from_bytes(v, data))
    model = make_model(conf.get_config("model"), device="cpu")
    model.load_state_dict(convert.from_jax_variables(got), strict=True)
    want = convert.from_jax_variables(v)
    for k, t in model.state_dict().items():
        torch.testing.assert_close(t, want[k], rtol=0, atol=0, msg=k)


def test_read_flax_msgpack_leaf_kinds(tmp_path):
    """bf16 and f32 leaves, numpy scalars (flax's npscalar extension),
    Python int, float, str, bool and None, written by flax.serialization.
    to_bytes (save_pytree turns every leaf into an ndarray first)."""
    rng = np.random.default_rng(0)
    tree = {
        "bf16": jnp.asarray(rng.normal(size=(3, 5)), jnp.bfloat16),
        "f32": rng.normal(size=(4, 2, 3)).astype(np.float32),
        "i32": rng.integers(-9, 9, size=(7,)).astype(np.int32),
        "empty": np.zeros((0, 3), np.float32),
        "scalars": {"f32": np.float32(2.5), "i64": np.int64(-7),
                    "bf16": jnp.bfloat16(1.25)},
        "py": {"int": 300, "neg": -40000, "big": 2 ** 40, "float": 0.1,
               "true": True, "false": False, "none": None, "str": "x" * 40},
    }
    path = str(tmp_path / "leaves")
    data = flax.serialization.to_bytes(tree)
    with open(path, "wb") as f:
        f.write(data)
    want = flax.serialization.msgpack_restore(data)
    assert isinstance(want["scalars"]["f32"], np.float32)
    got = convert.read_flax_msgpack(path)
    scalar = got["scalars"].pop("bf16")
    assert isinstance(scalar, torch.Tensor) and scalar.shape == ()
    assert scalar.dtype == torch.bfloat16 and float(scalar) == 1.25
    want["scalars"].pop("bf16")
    _assert_same_tree(got, want)


def test_read_flax_msgpack_chunked(tmp_path, monkeypatch):
    """Leaves over flax's MAX_CHUNK_SIZE (lowered here) are written as
    {"__msgpack_chunked_array__": ...} and joined back."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(1)
    tree = {"big": rng.normal(size=(10, 13)).astype(np.float32),
            "big_bf16": jnp.asarray(rng.normal(size=(9, 11)), jnp.bfloat16),
            "small": np.arange(4, dtype=np.float32)}
    path = str(tmp_path / "chunked")
    save_pytree(path, tree)
    with open(path, "rb") as f:
        data = f.read()
    assert b"__msgpack_chunked_array__" in data
    got = convert.read_flax_msgpack(path)
    _assert_same_tree(got, flax.serialization.msgpack_restore(data))
    _assert_same_tree(got, jax.tree.map(np.asarray, tree))


def _conf_file(tmp_path, **kw):
    path = tmp_path / "model.conf"
    path.write_text(flagship_conf_text(**kw))
    return str(path)


def _load(tmp_path, conf, name, seed):
    """A fresh port model (its own seed) with checkpoints/<name>/
    pixel_nerf_latest loaded strictly by train.checkpoints.load_weights."""
    model = make_model(conf.get_config("model"), device="cpu", seed=seed)
    args = argparse.Namespace(checkpoints_path=str(tmp_path / "checkpoints"),
                              name=name, resume=True)
    assert checkpoints.load_weights(args, model)
    return model


def _forward_matches(jm, v, tm):
    """Encode and both MLPs' field forward, port against JAX."""
    images, poses, focal = scene(ns=2)
    jc = jm.encode(v, jnp.asarray(images), jnp.asarray(poses),
                   jnp.asarray(focal))
    tc = tm.encode(images, poses, focal)
    rng = np.random.default_rng(3)
    xyz = (rng.normal(size=(1, 50, 3)) * 0.3).astype(np.float32)
    vd = rng.normal(size=(1, 50, 3)).astype(np.float32)
    for coarse in (True, False):
        ref = np.asarray(jm.forward(v, jc, jnp.asarray(xyz), coarse=coarse,
                                    viewdirs=jnp.asarray(vd)))
        got = to_np(tm.forward(tc, torch.from_numpy(xyz), coarse=coarse,
                               viewdirs=torch.from_numpy(vd)))
        np.testing.assert_allclose(got, ref, atol=FWD_TOL)


def _out(tmp_path, name):
    return str(tmp_path / "checkpoints" / name / "pixel_nerf_latest")


def test_jax_ckpt_cli_matches_jax(tmp_path, nerf_side):
    """--jax_ckpt: a JAX-package pixel_nerf_latest becomes a port checkpoint
    that load_weights loads strictly and whose forward is JAX's."""
    conf, jm, v = nerf_side
    src = str(tmp_path / "jax_latest")
    save_pytree(src, v)
    convert.main(["--jax_ckpt", src, "--conf", _conf_file(
        tmp_path, d_hidden=64, backbone="resnet18", num_layers=2),
        "--out", _out(tmp_path, "from_jax"), "--device", "cpu"])
    _forward_matches(jm, v, _load(tmp_path, conf, "from_jax", seed=5))


def _reference_sd(model, seed=0):
    """The port model's state_dict as the reference saves it: the same key
    names plus the non-persistent buffers."""
    g = torch.Generator().manual_seed(seed)
    sd = dict(model.state_dict())
    for name in convert.REFERENCE_BUFFERS[:-1]:
        sd[name] = torch.randn(2, 3, generator=g)
    return sd


def test_torch_ckpt_cli_matches_jax(tmp_path, nerf_side, capsys):
    """--torch_ckpt: a reference-layout state_dict (with the reference's
    buffers) gives the field that JAX's convert_reference_state_dict
    followed by the JAX forward gives."""
    conf, jm, v = nerf_side
    sd = _reference_sd(port_model(conf, v))
    src = str(tmp_path / "reference_latest")
    torch.save(sd, src)
    convert.main(["--torch_ckpt", src, "--conf", _conf_file(
        tmp_path, d_hidden=64, backbone="resnet18", num_layers=2),
        "--out", _out(tmp_path, "from_torch"), "--device", "cpu"])
    printed = capsys.readouterr().out
    for name in convert.REFERENCE_BUFFERS[:-1]:
        assert name in printed
    jv = convert_reference_state_dict({k: t.numpy() for k, t in sd.items()},
                                      backbone="resnet18")
    _forward_matches(jm, jv, _load(tmp_path, conf, "from_torch", seed=5))


def test_custom_backbone_keeps_seeded_encoder(tmp_path):
    """A checkpoint without torchvision encoder weights (the reference's
    YOLOv7 backbone): a warning, the encoder of the model made from --seed,
    the MLP from the file."""
    conf = small_yolo()
    src_model = make_model(conf.get_config("model"), device="cpu", seed=7)
    with torch.no_grad():
        for p in src_model.mlp_coarse.parameters():
            p.add_(0.01)
    sd = {k: t for k, t in _reference_sd(src_model).items()
          if not k.startswith("encoder.model.")}
    sd["encoder.model.yolov7.0.conv.weight"] = torch.zeros(4, 3, 3, 3)
    seeded = make_model(conf.get_config("model"), device="cpu", seed=3)
    with pytest.warns(UserWarning, match="custom YOLOv7"):
        got = convert.from_reference_state_dict(sd, seeded)
    for k, t in seeded.state_dict().items():
        want = sd[k] if k.startswith("mlp_coarse.") else t
        torch.testing.assert_close(got[k], want, rtol=0, atol=0, msg=k)


def test_global_encoder_refused(tmp_path):
    """A reference-layout checkpoint with a global encoder
    (global_encoder.model.*, global_encoder.fc.*), which the port once
    refused, converts through --torch_ckpt, loads strictly, and gives the
    field that JAX's convert_reference_state_dict followed by the JAX
    forward gives."""
    conf = small_flagship()
    conf.put("model.use_global_encoder", True)
    conf.put("model.global_encoder", {"backbone": "resnet18",
                                      "pretrained": False,
                                      "latent_size": 32})
    jm = jmake_model(conf.get_config("model"))
    v = perturbed_variables(jm, scene(ns=2)[0][0], encoder_stats=True)
    sd = _reference_sd(port_model(conf, v))
    assert "global_encoder.fc.weight" in sd
    assert "global_encoder.model.layer4.1.bn2.running_var" in sd
    src = str(tmp_path / "reference_latest")
    torch.save(sd, src)
    path = tmp_path / "model.conf"
    path.write_text(flagship_conf_text(d_hidden=64, backbone="resnet18",
                                       num_layers=2).replace(
        "model {", "model { use_global_encoder = True\n"
        " global_encoder { backbone = resnet18\n pretrained = False\n"
        " latent_size = 32 }", 1))
    convert.main(["--torch_ckpt", src, "--conf", str(path), "--out",
                  _out(tmp_path, "global"), "--device", "cpu"])
    jv = convert_reference_state_dict({k: t.numpy() for k, t in sd.items()},
                                      backbone="resnet18")
    assert "global_encoder" in jv["params"]
    _forward_matches(jm, jv, _load(tmp_path, conf, "global", seed=5))


def test_missing_keys_taken_from_model(nerf_side):
    """Keys the checkpoint lacks (here mlp_fine) keep the model's values,
    listed in the warning; the result is a complete state_dict."""
    conf, _, v = nerf_side
    sd = {k: t for k, t in port_model(conf, v).state_dict().items()
          if not k.startswith("mlp_fine.")}
    model = make_model(conf.get_config("model"), device="cpu", seed=9)
    with pytest.warns(UserWarning, match="mlp_fine.lin_out.weight"):
        got = convert.from_reference_state_dict(sd, model)
    assert got.keys() == model.state_dict().keys()
    for k, t in model.state_dict().items():
        want = t if k.startswith("mlp_fine.") or "num_batches" in k else sd[k]
        torch.testing.assert_close(got[k], want, rtol=0, atol=0, msg=k)


def test_cli_into_eval_yolo(tmp_path):
    """The --torch_ckpt CLI's file drives eval_yolo on the CPU to the same
    metrics as a checkpoint the port saved itself from the same model."""
    from synth_data import make_yolo_dataset
    from test_train_integration import YOLO_TRAIN_CONF

    from pixelnerf_yolo_torch.config.hocon import parse_string
    from pixelnerf_yolo_torch.eval import eval_yolo

    root = make_yolo_dataset(str(tmp_path / "data"), n_scenes=2, n_views=4,
                             img_size=64)
    conf_path = tmp_path / "yolo.conf"
    conf_path.write_text(YOLO_TRAIN_CONF)
    conf = parse_string(YOLO_TRAIN_CONF)
    model = make_model(conf.get_config("model"), device="cpu", seed=4)
    with torch.no_grad():  # objectness logits up: boxes to match
        model.mlp_coarse.lin_out.bias[0::7] += 4.0
    direct = argparse.Namespace(checkpoints_path=str(tmp_path / "checkpoints"),
                                name="direct")
    checkpoints.save_weights(direct, model)
    src = str(tmp_path / "reference_latest")
    torch.save(_reference_sd(model), src)
    convert.main(["--torch_ckpt", src, "--conf", str(conf_path), "--out",
                  _out(tmp_path, "converted"), "--device", "cpu"])

    def run(name):
        return eval_yolo.main([
            "-n", name, "-c", str(conf_path), "-D", root, "-F", "yolo",
            "-V", "3", "--checkpoints_path", str(tmp_path / "checkpoints"),
            "--logs_path", str(tmp_path / "logs"),
            "--visual_path", str(tmp_path / "visuals"), "--device", "cpu"])

    got, want = run("converted"), run("direct")
    assert got["tp"] + got["fp"] > 0
    assert got == want
