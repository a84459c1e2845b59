"""Carry JAX-package weights into the port.

``from_jax_variables`` maps the JAX package's ``{"params", "batch_stats"}``
pytree (nested dicts of numpy arrays) onto a port ``state_dict`` with the
reference PixelNeRFNet key names, so that the JAX package's
``convert_reference_state_dict`` maps a port state_dict straight back:

  encoder/model/conv1, BatchNorm_0          -> encoder.model.conv1, bn1
  encoder/model/layerN_i/{conv1, conv2}     -> encoder.model.layerN.i.*
  .../{BatchNorm_0, BatchNorm_1}            -> ....{bn1, bn2}
  .../{downsample_conv, BatchNorm_2}        -> ....downsample.{0, 1}
  mlp_*/lin_in, lin_out, lin_z_N, block_N   -> mlp_*.lin_in, lin_out,
                                               lin_z.N, blocks.N
  mlp_*/scale_z_N (SPADE)                   -> mlp_*.scale_z.N
  mlp_*/lin_N (ImplicitNet)                 -> mlp_*.linN
  global_encoder/model/*                    -> global_encoder.model.*, as
                                               encoder/model/* above
  global_encoder/fc                         -> global_encoder.fc
A ResNet built with another norm_type has GroupNorm_k in place of
BatchNorm_k (scale and bias only; none with "instance" or "none"), mapped
to the same bn1 / bn2 / downsample.1.
The custom ELAN backbone and the conv encoder have no reference key names
(the reference's external YOLOv7 is not vendored, its ConvEncoder is never
built), so their port modules carry the flax names and a flax path maps
onto its key by joining it with dots:

  encoder/model/ConvBnAct_i/{Conv_0, BatchNorm_0}
  encoder/model/ELANBlock_j/ConvBnAct_k/{Conv_0, BatchNorm_0}
  encoder/model/{Conv_0 .. Conv_8, GroupNorm_0 .. GroupNorm_7}  (conv)

Dense kernels (in, out) become weights (out, in); conv kernels HWIO become
OIHW; BatchNorm scale/bias/mean/var become weight/bias/running_mean/
running_var; GroupNorm scale/bias become weight/bias.

Two files reach a port checkpoint (``checkpoints/<name>/pixel_nerf_latest``,
what ``train.checkpoints.load_weights``, the evaluation CLIs and serve.py
read):

  python -m pixelnerf_yolo_torch.convert --torch_ckpt PATH \
      --conf conf/exp/srn.conf --out checkpoints/srn/pixel_nerf_latest
  python -m pixelnerf_yolo_torch.convert --jax_ckpt PATH \
      --conf conf/exp/yolo.conf --out checkpoints/yolo/pixel_nerf_latest

  --torch_ckpt  a reference PixelNeRFNet state_dict (torch.save):
                ``from_reference_state_dict`` reads the keys the JAX
                package's ``train/convert.py::convert_reference_state_dict``
                reads, which carry the port's own names already;
  --jax_ckpt    a JAX-package checkpoint (flax msgpack,
                ``train/checkpoints.py::save_pytree``): ``read_flax_msgpack``
                decodes it in pure Python (no msgpack, flax or jax) and
                ``from_jax_variables`` maps it.
Keys the model built from --conf with --seed has but the file lacks keep
the model's values (with a warning that lists them), so the written
state_dict is complete and loads strictly.  --device (default cuda) is
where that model is built.
"""

from __future__ import annotations

import argparse
import os
import re
import struct
import warnings

import numpy as np
import torch

# the reference PixelNeRFNet's non-persistent buffers, and its encoders'
# (models.py, encoder.py): a state_dict may carry them, no converter reads
# them
REFERENCE_BUFFERS = ("poses", "image_shape", "focal", "c", "encoder.latent",
                     "encoder.latent_scaling", "global_encoder.latent")


def _t(a) -> torch.Tensor:
    """An f32 CPU tensor of a numpy array or a tensor (bf16 leaves too)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32).clone()
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(sd: dict, key: str, p: dict):
    sd[key + ".weight"] = _t(p["kernel"]).permute(3, 2, 0, 1).contiguous()


def _bn(sd: dict, key: str, p: dict, s: dict):
    sd[key + ".weight"] = _t(p["scale"])
    sd[key + ".bias"] = _t(p["bias"])
    sd[key + ".running_mean"] = _t(s["mean"])
    sd[key + ".running_var"] = _t(s["var"])
    sd[key + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _dense(sd: dict, key: str, p: dict):
    sd[key + ".weight"] = _t(p["kernel"]).T.contiguous()
    if "bias" in p:
        sd[key + ".bias"] = _t(p["bias"])


def _gn(sd: dict, key: str, p: dict):
    sd[key + ".weight"] = _t(p["scale"])
    sd[key + ".bias"] = _t(p["bias"])


_BLOCK_BN = {"_0": "bn1", "_1": "bn2", "_2": "downsample.1"}


def _resnet(sd: dict, prefix: str, params: dict, stats: dict):
    """A ResNet trunk; its norms BatchNorm_k (with statistics) or
    GroupNorm_k (scale and bias), or none (instance, none)."""
    def norm(key, p, s, suffix):
        if "BatchNorm" + suffix in p:
            _bn(sd, key, p["BatchNorm" + suffix], s["BatchNorm" + suffix])
        elif "GroupNorm" + suffix in p:
            _gn(sd, key, p["GroupNorm" + suffix])

    _conv(sd, prefix + "conv1", params["conv1"])
    norm(prefix + "bn1", params, stats, "_0")
    for name, bp in params.items():
        m = re.fullmatch(r"layer(\d)_(\d+)", name)
        if m is None:
            continue
        key = f"{prefix}layer{m[1]}.{m[2]}."
        _conv(sd, key + "conv1", bp["conv1"])
        _conv(sd, key + "conv2", bp["conv2"])
        if "downsample_conv" in bp:
            _conv(sd, key + "downsample.0", bp["downsample_conv"])
        for suffix, torch_name in _BLOCK_BN.items():
            norm(key + torch_name, bp, stats.get(name, {}), suffix)


def _conv_encoder(sd: dict, prefix: str, params: dict):
    """The conv encoder's Conv_i (kernel, Conv_8 also a bias) and
    GroupNorm_i leaves; raises on a leaf it does not map."""
    for name, p in params.items():
        if re.fullmatch(r"Conv_\d", name):
            _conv(sd, prefix + name, p)
            if "bias" in p:
                sd[prefix + name + ".bias"] = _t(p["bias"])
        elif re.fullmatch(r"GroupNorm_\d", name):
            _gn(sd, prefix + name, p)
        else:
            raise NotImplementedError(f"{prefix}{name} has no port "
                                      "counterpart")


def _yolo_backbone(sd: dict, prefix: str, params: dict, stats: dict):
    """Every Conv_0 / BatchNorm_0 leaf of the ELAN tree; raises on a leaf
    it does not map."""
    for name, p in params.items():
        key = prefix + name
        if name == "Conv_0" and set(p) == {"kernel"}:
            _conv(sd, key, p)
        elif name == "BatchNorm_0" and set(p) == {"scale", "bias"} \
                and set(stats[name]) == {"mean", "var"}:
            _bn(sd, key, p, stats[name])
        elif re.fullmatch(r"(ConvBnAct|ELANBlock)_\d+", name):
            _yolo_backbone(sd, key + ".", p, stats[name])
        else:
            raise NotImplementedError(f"{key} has no port counterpart")


def resnetfc_state_dict(params: dict, prefix: str = "") -> dict:
    """Flax ResnetFC (or ImplicitNet: lin_N) params -> port state_dict
    entries."""
    sd: dict = {}
    for name, p in params.items():
        if m := re.fullmatch(r"lin_(\d+)", name):
            _dense(sd, f"{prefix}lin{m[1]}", p)
        elif name in ("lin_in", "lin_out"):
            _dense(sd, prefix + name, p)
        elif m := re.fullmatch(r"(lin_z|scale_z)_(\d+)", name):
            _dense(sd, f"{prefix}{m[1]}.{m[2]}", p)
        elif m := re.fullmatch(r"block_(\d+)", name):
            for leaf, lp in p.items():
                _dense(sd, f"{prefix}blocks.{m[1]}.{leaf}", lp)
        else:
            raise NotImplementedError(f"{prefix}{name} has no port counterpart")
    return sd


def from_jax_variables(variables: dict) -> dict:
    """JAX ``{"params", "batch_stats"}`` pytree -> port state_dict (CPU)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    extra = set(params) - {"encoder", "global_encoder", "mlp_coarse",
                           "mlp_fine"}
    if extra:
        raise NotImplementedError(f"{sorted(extra)} have no port counterpart")
    sd: dict = {}
    enc = params["encoder"]["model"]
    enc_stats = stats.get("encoder", {}).get("model", {})
    if "ConvBnAct_0" in enc:
        _yolo_backbone(sd, "encoder.model.", enc, enc_stats)
    elif "Conv_0" in enc:
        _conv_encoder(sd, "encoder.model.", enc)
    else:
        _resnet(sd, "encoder.model.", enc, enc_stats)
    if "global_encoder" in params:
        glob = params["global_encoder"]
        _resnet(sd, "global_encoder.model.", glob["model"],
                stats["global_encoder"]["model"])
        if "fc" in glob:
            _dense(sd, "global_encoder.fc", glob["fc"])
    for name in ("mlp_coarse", "mlp_fine"):
        if name in params:
            sd.update(resnetfc_state_dict(params[name], name + "."))
    return sd


# -- flax msgpack --------------------------------------------------------------

# flax.serialization's msgpack extension codes
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Msgpack:
    """A msgpack decoder of what flax.serialization.to_bytes writes: maps,
    arrays, str, bin, int, float, nil, bool and flax's extensions."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def obj(self):
        t = self.uint(1)
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if t <= 0x8F:
            return self.map(t & 0x0F)
        if t <= 0x9F:
            return [self.obj() for _ in range(t & 0x0F)]
        if t <= 0xBF:
            return self.take(t & 0x1F).decode("utf-8")
        if t in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[t]
        if 0xC4 <= t <= 0xC6:  # bin 8/16/32
            return self.take(self.uint(1 << (t - 0xC4)))
        if 0xC7 <= t <= 0xC9:  # ext 8/16/32
            n = self.uint(1 << (t - 0xC7))
            code = int.from_bytes(self.take(1), "big", signed=True)
            return _ext(code, self.take(n))
        if t in (0xCA, 0xCB):
            return struct.unpack(">f" if t == 0xCA else ">d",
                                 self.take(4 if t == 0xCA else 8))[0]
        if 0xCC <= t <= 0xCF:
            return self.uint(1 << (t - 0xCC))
        if 0xD0 <= t <= 0xD3:
            return int.from_bytes(self.take(1 << (t - 0xD0)), "big",
                                  signed=True)
        if 0xD4 <= t <= 0xD8:  # fixext 1/2/4/8/16
            code = int.from_bytes(self.take(1), "big", signed=True)
            return _ext(code, self.take(1 << (t - 0xD4)))
        if 0xD9 <= t <= 0xDB:
            return self.take(self.uint(1 << (t - 0xD9))).decode("utf-8")
        if t in (0xDC, 0xDD):
            return [self.obj() for _ in range(self.uint(2 if t == 0xDC
                                                         else 4))]
        if t in (0xDE, 0xDF):
            return self.map(self.uint(2 if t == 0xDE else 4))
        raise ValueError(f"msgpack type byte 0x{t:02x} is not valid")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out


def _ndarray(data: bytes):
    """flax's ndarray encoding, msgpack (shape, dtype name, C-order bytes):
    a numpy array, or a torch.bfloat16 tensor (numpy has no bfloat16)."""
    shape, name, buf = _Msgpack(data).obj()
    if isinstance(name, bytes):
        name = name.decode()
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.uint16).reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def _ext(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        arr = _ndarray(data)
        return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
    if code == _EXT_COMPLEX:
        real, imag = _Msgpack(data).obj()
        return complex(real, imag)
    raise ValueError(f"msgpack extension type {code} is not flax's")


def _unchunk(tree):
    """flax's chunked form of a leaf over MAX_CHUNK_SIZE bytes,
    {"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks":
    {"0": flat array, ...}}, joined back into the array; other dicts
    walked."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_flax_msgpack(path: str) -> dict:
    """The pytree a JAX-package checkpoint holds (``save_pytree``, flax
    msgpack), as nested dicts of numpy arrays (torch.bfloat16 tensors for
    bf16 leaves, numpy scalars for scalars), with no import of msgpack,
    flax or jax."""
    with open(path, "rb") as f:
        reader = _Msgpack(f.read())
    tree = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError(f"{path}: {len(reader.data) - reader.pos} bytes "
                         "after the msgpack object")
    return _unchunk(tree)


# -- reference state_dicts -----------------------------------------------------

_BN = ("weight", "bias", "running_mean", "running_var")


def _reference_encoder_keys(sd: dict, backbone: str,
                            p: str = "encoder.model.") -> list:
    """The ``p``* keys that the JAX package's ``port_torch_state_dict``
    reads (torchvision names)."""
    from .nn.resnet import STAGE_SIZES

    if backbone not in STAGE_SIZES:
        raise ValueError(f"the checkpoint has a torchvision encoder, the "
                         f"conf's backbone is {backbone!r}")
    keys = [p + "conv1.weight"] + [f"{p}bn1.{k}" for k in _BN]
    for stage, n_blocks in enumerate(STAGE_SIZES[backbone], start=1):
        for i in range(n_blocks):
            t = f"{p}layer{stage}.{i}."
            if t + "conv1.weight" not in sd:
                continue
            keys += [t + "conv1.weight", t + "conv2.weight"]
            keys += [f"{t}{bn}.{k}" for bn in ("bn1", "bn2") for k in _BN]
            if t + "downsample.0.weight" in sd:
                keys += [t + "downsample.0.weight"]
                keys += [f"{t}downsample.1.{k}" for k in _BN]
    return keys


def _reference_resnetfc_keys(sd: dict, prefix: str) -> list:
    """The keys of one ResnetFC that the JAX package's
    ``convert_resnetfc`` reads."""
    keys = []

    def linear(name):
        keys.append(name + ".weight")
        if name + ".bias" in sd:
            keys.append(name + ".bias")

    if prefix + "lin_in.weight" in sd:
        linear(prefix + "lin_in")
    linear(prefix + "lin_out")
    i = 0
    while f"{prefix}blocks.{i}.fc_0.weight" in sd:
        for leaf in ("fc_0", "fc_1", "shortcut"):
            if leaf != "shortcut" or f"{prefix}blocks.{i}.{leaf}.weight" in sd:
                linear(f"{prefix}blocks.{i}.{leaf}")
        i += 1
    for name in ("lin_z", "scale_z"):
        i = 0
        while f"{prefix}{name}.{i}.weight" in sd:
            linear(f"{prefix}{name}.{i}")
            i += 1
    return keys


def from_reference_state_dict(sd: dict, model) -> dict:
    """A reference PixelNeRFNet state_dict -> a complete state_dict of the
    port ``model`` (CPU tensors in the model's dtypes).

    Reads exactly the keys the JAX package's ``convert_reference_state_dict``
    reads: the torchvision encoder (when the file has one) and each
    ResnetFC, and the global encoder (``global_encoder.model.*`` as a
    torchvision trunk of the model's global backbone, which is the JAX
    converter's one ``backbone`` when the two encoders share it, and
    ``global_encoder.fc.*``).  Every other key (the non-persistent buffers
    ``REFERENCE_BUFFERS``, BatchNorm's num_batches_tracked, a custom
    backbone's weights) is ignored, and its name printed.  A file without
    a torchvision encoder (the reference's external YOLOv7 "custom"
    backbone) keeps the model's encoder with a warning, as the JAX package
    keeps its random init; the model's values fill every key the file
    does not give, listed in a warning.
    """
    read = []
    own = model.state_dict()
    seeded = ()
    if "encoder.model.conv1.weight" in sd:
        read += _reference_encoder_keys(sd, model.encoder.backbone)
    else:
        warnings.warn(
            "checkpoint has no torchvision encoder weights (custom YOLOv7 "
            "backbone?): the encoder keeps the model's seeded init")
        seeded = [k for k in own if k.startswith("encoder.")]
    for name in ("mlp_coarse", "mlp_fine"):
        if f"{name}.lin_out.weight" in sd:
            read += _reference_resnetfc_keys(sd, name + ".")
    if "global_encoder.model.conv1.weight" in sd:
        glob = model.global_encoder
        read += _reference_encoder_keys(
            sd, glob.backbone if glob is not None else "resnet34",
            "global_encoder.model.")
        if "global_encoder.fc.weight" in sd:
            read += ["global_encoder.fc.weight"]
            if "global_encoder.fc.bias" in sd:
                read += ["global_encoder.fc.bias"]
    unused = [k for k in read if k not in own]
    ignored = sorted(set(sd) - set(read)) + unused
    if ignored:
        print(f"ignored {len(ignored)} checkpoint keys: {', '.join(ignored)}")
    converted = {k: torch.as_tensor(sd[k]).detach().to("cpu", own[k].dtype)
                 for k in read if k in own}
    return _complete(converted, own, announced=seeded)


def _complete(converted: dict, own: dict, announced=()) -> dict:
    """converted with the model's values (``own``, its state_dict) for the
    keys it lacks, listed in a warning (but for the ``announced`` ones);
    a key the model lacks raises."""
    extra = [k for k in converted if k not in own]
    if extra:
        raise ValueError(f"the model built from the conf has no {extra}")
    missing = [k for k in own if k not in converted and k not in announced]
    if missing:
        warnings.warn(f"{len(missing)} keys taken from the model built from "
                      f"the conf: {', '.join(missing)}")
    return {k: converted[k] if k in converted
            else own[k].detach().to("cpu") for k in own}


# -- command line ----------------------------------------------------------------


def main(argv=None) -> str:
    """Convert a checkpoint (see the module docstring); returns the path
    written."""
    from .config.hocon import parse_file
    from .models import make_model
    from .train import checkpoints

    ap = argparse.ArgumentParser(
        prog="python -m pixelnerf_yolo_torch.convert",
        description="Convert a reference torch or JAX-package checkpoint "
        "into a port checkpoint")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--torch_ckpt", help="reference PixelNeRFNet "
                     "state_dict (torch.save)")
    src.add_argument("--jax_ckpt", help="JAX-package checkpoint (flax "
                     "msgpack)")
    ap.add_argument("--conf", "-c", required=True,
                    help="the model's conf (model section)")
    ap.add_argument("--out", required=True,
                    help="file to write, e.g. checkpoints/<name>/"
                    "pixel_nerf_latest")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the model whose values fill keys the "
                    "checkpoint lacks")
    ap.add_argument("--device", default="cuda",
                    help="device the model is built on (cuda or cpu)")
    args = ap.parse_args(argv)

    conf_path = args.conf
    if not os.path.exists(conf_path):
        # a conf named relative to the repo, as the CLIs look them up
        root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
        conf_path = os.path.join(root, conf_path)
    conf = parse_file(conf_path)
    model = make_model(conf.get_config("model"), device=args.device,
                       seed=args.seed, load_pretrained=False)
    if args.torch_ckpt:
        sd = torch.load(args.torch_ckpt, map_location="cpu",
                        weights_only=True)
        state = from_reference_state_dict(sd, model)
    else:
        state = _complete(from_jax_variables(read_flax_msgpack(
            args.jax_ckpt)), model.state_dict())
    model.load_state_dict(state, strict=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    checkpoints.save_state(
        args.out, {k: v.detach().cpu() for k, v in model.state_dict().items()})
    print("wrote", args.out)
    return args.out


if __name__ == "__main__":
    main()
