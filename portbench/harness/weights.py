"""Random weights from the seed, made on the device in a few large draws.

A reference's ``param_specs(cfg)`` lists every tensor as (name, shape,
init) (``reference/common.py::Spec``). One uniform draw covers every drawn
tensor and one normal draw every ``normal`` one; each tensor is then a
scaled slice of its draw. Weight-norm gains are the norms of their v.
"""
from __future__ import annotations

import math

import torch

_RANGES = {"snake": (-0.3, 0.3), "norm": (0.8, 1.2), "bias": (-0.1, 0.1)}


def _range(init, shape):
    if init in _RANGES:
        return _RANGES[init]
    if init == "fan_in":
        b = 1.0 / math.sqrt(math.prod(shape[1:]))
        return -b, b
    if init.startswith("fan_in:"):
        b = 1.0 / math.sqrt(int(init.split(":", 1)[1]))
        return -b, b
    raise ValueError(f"unknown init {init!r}")


def make_weights(specs, seed: int, device) -> dict:
    """{name: fp32 tensor on ``device``} for every spec, from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    drawn = [s for s in specs if s[2] != "normal" and not s[2].startswith("wn_g:")]
    normal = [s for s in specs if s[2] == "normal"]
    out = {}
    with torch.no_grad():
        flat = torch.rand(sum(math.prod(s[1]) for s in drawn), generator=gen, device=device)
        at = 0
        for name, shape, init in drawn:
            n = math.prod(shape)
            lo, hi = _range(init, shape)
            out[name] = (flat[at:at + n] * (hi - lo) + lo).reshape(shape)
            at += n
        del flat
        if normal:
            flat = torch.randn(sum(math.prod(s[1]) for s in normal), generator=gen, device=device)
            at = 0
            for name, shape, _ in normal:
                n = math.prod(shape)
                out[name] = flat[at:at + n].reshape(shape).clone()
                at += n
        for name, shape, init in specs:
            if init.startswith("wn_g:"):
                v = out[init.split(":", 1)[1]]
                out[name] = torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.ndim)),
                                                 keepdim=True)).reshape(shape)
    return {s[0]: out[s[0]] for s in specs}
