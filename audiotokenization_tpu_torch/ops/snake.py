"""SnakeBeta activation with log-scale parameters (the form every trained
config uses): snake_beta(x) = x + sin²(e^α·x) / (e^β + 1e-9), per channel
over (B, C, T). Counterpart of ``audiotokenization_tpu/ops/snake.py``; only
the sin² form is ported (the cos form is a training option there)."""
from __future__ import annotations

import torch
from torch import nn

_EPS = 1e-9


def snake_beta(x, alpha, beta):
    a = torch.exp(alpha)[None, :, None]
    b = torch.exp(beta)[None, :, None]
    s = torch.sin(x * a)
    return x + (1.0 / (b + _EPS)) * (s * s)


class SnakeBeta(nn.Module):
    """Per-channel ``alpha`` and ``beta`` in log scale, initialised to 0."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return snake_beta(x, self.alpha, self.beta)
