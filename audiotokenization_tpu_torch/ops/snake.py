"""Snake and SnakeBeta activations (counterpart of
``audiotokenization_tpu/ops/snake.py``), per channel over (B, C, T):

    snake(x)      = x + sin²(a·x) / (a + 1e-9),  a = e^α
    snake_beta(x) = x + sin²(a·x) / (b + 1e-9),  a = e^α, b = e^β

with the parameters in log scale (every trained config), or as they are
with ``logscale=False``.

``cos_form=True`` computes sin²(a·x) as (1 - cos(2a·x)) / 2, one
transcendental in the forward and one in the gradient: the form that the
JAX package's ``cos_form()`` context selects while tracing. The two forms
differ by rounding only. It is an argument here, not a process-wide
switch: no path of the port sets it, and every model, K2's plain version
and its recompute compute sin².
"""
from __future__ import annotations

import torch
from torch import nn

_EPS = 1e-9


def _sin2(x, a, cos_form: bool):
    if cos_form:
        return 0.5 - 0.5 * torch.cos(2.0 * (x * a))
    s = torch.sin(x * a)
    return s * s


def snake(x, alpha, *, logscale: bool = True, cos_form: bool = False):
    a = alpha[None, :, None]
    if logscale:
        a = torch.exp(a)
    return x + (1.0 / (a + _EPS)) * _sin2(x, a, cos_form)


def snake_beta(x, alpha, beta, *, logscale: bool = True, cos_form: bool = False):
    a, b = alpha[None, :, None], beta[None, :, None]
    if logscale:
        a, b = torch.exp(a), torch.exp(b)
    return x + (1.0 / (b + _EPS)) * _sin2(x, a, cos_form)


class SnakeBeta(nn.Module):
    """Per-channel ``alpha`` and ``beta`` in log scale, initialised to 0."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return snake_beta(x, self.alpha, self.beta)
