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
The custom ELAN backbone has no reference key names (the reference's
external YOLOv7 is not vendored), so its port modules carry the flax names
and a flax path maps onto its key by joining it with dots:

  encoder/model/ConvBnAct_i/{Conv_0, BatchNorm_0}
  encoder/model/ELANBlock_j/ConvBnAct_k/{Conv_0, BatchNorm_0}

Dense kernels (in, out) become weights (out, in); conv kernels HWIO become
OIHW; BatchNorm scale/bias/mean/var become weight/bias/running_mean/
running_var.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(sd: dict, key: str, p: dict):
    sd[key + ".weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))


def _bn(sd: dict, key: str, p: dict, s: dict):
    sd[key + ".weight"] = _t(p["scale"])
    sd[key + ".bias"] = _t(p["bias"])
    sd[key + ".running_mean"] = _t(s["mean"])
    sd[key + ".running_var"] = _t(s["var"])
    sd[key + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _dense(sd: dict, key: str, p: dict):
    sd[key + ".weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[key + ".bias"] = _t(p["bias"])


_BLOCK_BN = {"BatchNorm_0": "bn1", "BatchNorm_1": "bn2",
             "BatchNorm_2": "downsample.1"}


def _resnet(sd: dict, prefix: str, params: dict, stats: dict):
    _conv(sd, prefix + "conv1", params["conv1"])
    _bn(sd, prefix + "bn1", params["BatchNorm_0"], stats["BatchNorm_0"])
    for name, bp in params.items():
        m = re.fullmatch(r"layer(\d)_(\d+)", name)
        if m is None:
            continue
        key = f"{prefix}layer{m[1]}.{m[2]}."
        _conv(sd, key + "conv1", bp["conv1"])
        _conv(sd, key + "conv2", bp["conv2"])
        if "downsample_conv" in bp:
            _conv(sd, key + "downsample.0", bp["downsample_conv"])
        for bn_name, torch_name in _BLOCK_BN.items():
            if bn_name in bp:
                _bn(sd, key + torch_name, bp[bn_name], stats[name][bn_name])


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
    """Flax ResnetFC params -> port ResnetFC state_dict entries."""
    sd: dict = {}
    for name, p in params.items():
        if name in ("lin_in", "lin_out"):
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
    extra = set(params) - {"encoder", "mlp_coarse", "mlp_fine"}
    if extra:
        raise NotImplementedError(f"{sorted(extra)} have no port counterpart")
    sd: dict = {}
    enc, enc_stats = params["encoder"]["model"], stats["encoder"]["model"]
    if "ConvBnAct_0" in enc:
        _yolo_backbone(sd, "encoder.model.", enc, enc_stats)
    else:
        _resnet(sd, "encoder.model.", enc, enc_stats)
    for name in ("mlp_coarse", "mlp_fine"):
        if name in params:
            sd.update(resnetfc_state_dict(params[name], name + "."))
    return sd
