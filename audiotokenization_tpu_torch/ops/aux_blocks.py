"""Auxiliary blocks: ECA, DropPath (stochastic depth), ScaleBiasLayer
(counterpart of ``audiotokenization_tpu/ops/aux_blocks.py``; the
reference's ``vq/module.py``). No trained configuration runs them; they
are part of the component inventory, for experiment variants.

``drop_path`` cannot draw JAX's ``bernoulli``: it takes the keep mask
handed in, or draws one from a ``torch.Generator``.
"""
from __future__ import annotations

import torch

from .conv import conv1d, kaiming_uniform_fan_in


def eca(x, weight, *, kernel_size: int = 5):
    """Efficient Channel Attention. x: (B, C, T); weight (1, 1, k): the
    mean over time, a 1-D conv across the channels, a sigmoid gate."""
    s = conv1d(x.mean(2)[:, None, :], weight, padding=(kernel_size - 1) // 2)
    return x * torch.sigmoid(s[:, 0, :])[:, :, None]


def init_eca(generator: torch.Generator, kernel_size: int = 5):
    return {"w": kaiming_uniform_fan_in((1, 1, kernel_size), generator=generator)}


def drop_path(x, *, rate: float, generator: torch.Generator | None = None, keep_mask=None,
              training: bool = True, scale_by_keep: bool = True):
    """Stochastic depth per sample: each sample of x (B, ...) is kept with
    probability 1 - ``rate`` (and scaled by 1 / keep with
    ``scale_by_keep``), else zeroed. ``keep_mask`` (B,) bool or 0/1 is the
    draw; without it one is drawn from ``generator`` (on x's device)."""
    if rate == 0.0 or not training:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    if keep_mask is None:
        keep_mask = torch.rand(x.shape[0], generator=generator, device=x.device) < keep
    mask = keep_mask.reshape(shape).to(x.dtype)
    if scale_by_keep and keep > 0.0:
        mask = mask / keep
    return x * mask


def scale_bias(x, scale, bias):
    """y = x · scale + bias over the last dim."""
    return x * scale[None, None, :] + bias[None, None, :]


def init_scale_bias(d_model: int, adaptive: bool = True):
    return {"scale": torch.ones(d_model), "bias": torch.zeros(d_model), "adaptive": adaptive}
