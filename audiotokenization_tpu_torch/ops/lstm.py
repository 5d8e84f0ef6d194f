"""LSTM and the codec's ResLSTM (counterpart of
``audiotokenization_tpu/ops/lstm.py``).

The JAX package runs the recurrence through ``lax.scan``; its gate order
[i, f, g, o] and weight layout (w_ih (4H, in), w_hh (4H, H), b_ih, b_hh) are
torch's, so the port holds the weights in an ``nn.LSTM`` (cuDNN on the
card). The masked (ragged) and streaming forms come with later slices.
"""
from __future__ import annotations

import math

import torch
from torch import nn


def lstm(x, module: nn.LSTM, *, valid=None):
    """x: (B, T, in) -> (B, T, H·directions), zero initial state."""
    if valid is not None:
        raise NotImplementedError("the masked LSTM path is not ported yet")
    return module(x)[0]


def res_lstm(x, module: nn.LSTM, *, valid=None):
    """ResLSTM: x (B, F, T) -> (B, F, T), with the residual skip."""
    xt = x.transpose(1, 2)
    y = lstm(xt, module, valid=valid) + xt
    return y.transpose(1, 2).contiguous()


def init_lstm(input_size: int, hidden_size: int, *, num_layers: int,
              bidirectional: bool = False,
              generator: torch.Generator) -> nn.LSTM:
    """nn.LSTM(batch_first=True) with torch's default init, U(-k, k) with
    k = 1/√hidden, drawn from ``generator``."""
    # built on the meta device so torch's own init draws nothing from the
    # global generator
    m = nn.LSTM(input_size, hidden_size, num_layers=num_layers,
                bidirectional=bidirectional, batch_first=True,
                device="meta").to_empty(device="cpu")
    k = 1.0 / math.sqrt(hidden_size)
    with torch.no_grad():
        for p in m.parameters():
            p.uniform_(-k, k, generator=generator)
    return m
