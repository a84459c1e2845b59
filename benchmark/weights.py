"""Weights from the seed: one draw of standard normals on the device,
cut into the parameters of the reference's module tree and scaled by the
configuration's rules.  The same dictionary loads into the program and
into the reference."""

from __future__ import annotations

import math
import re

import torch


def _scale(name: str, shape, rules) -> tuple[float, object]:
    """(std, mean) of a parameter: the first rule whose ``match`` (a regex)
    finds the name.  A rule gives ``std``, or ``gain`` for gain *
    sqrt(2 / fan_in); ``mean`` is a number or one value per element."""
    for rule in rules:
        if re.search(rule["match"], name):
            if "gain" in rule:
                std = rule["gain"] * math.sqrt(2.0 / math.prod(shape[1:]))
            else:
                std = rule.get("std", 0.0)
            return std, rule.get("mean", 0.0)
    raise KeyError(f"no init rule matches parameter {name}")


def make_weights(specs, rules, seed: int, device) -> dict:
    """specs [(name, shape)] -> {name: f32 tensor on device}."""
    total = sum(math.prod(s) for _, s in specs)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in specs:
        n = math.prod(shape)
        std, mean = _scale(name, shape, rules)
        mean = torch.as_tensor(mean, dtype=torch.float32, device=device)
        out[name] = (flat[at:at + n].reshape(shape) * std + mean.reshape(
            (-1,) + (1,) * (len(shape) - 1) if mean.numel() > 1 else ()))
        at += n
    return out


def specs_of(model: torch.nn.Module):
    return [(n, tuple(p.shape)) for n, p in model.named_parameters()]


def load_into(model: torch.nn.Module, weights: dict) -> None:
    """Copy weights into model's parameters; every parameter must be
    there and nothing else."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(weights))
    extra = sorted(set(weights) - set(params))
    if missing or extra:
        raise KeyError(f"weights and model disagree: missing {missing[:5]}"
                       f", unexpected {extra[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])
