"""LSTM and the codec's ResLSTM (counterpart of
``audiotokenization_tpu/ops/lstm.py``).

The JAX package runs the recurrence through ``lax.scan``; its gate order
[i, f, g, o] and weight layout (w_ih (4H, in), w_hh (4H, H), b_ih, b_hh) are
torch's, so the port holds the weights in an ``nn.LSTM`` (cuDNN on the
card). ``res_lstm_streaming`` is the streaming form: one-way, with each
layer's (h, c) carried from one chunk to the next.

Masked (ragged) batches: ``valid`` is a per-sample (B, T) prefix mask. As
in the JAX scan, a masked step neither updates the state nor emits output,
so each sample's reverse scan starts at its own last valid frame. Here the
batch is packed to its lengths (``pack_padded_sequence``, which cuDNN runs
per sample) and the padded outputs are zeroed. A row of length 0 is packed
as length 1 and its outputs zeroed: harmless, as in JAX.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from ..utils import trace


def _lengths(valid, shape) -> torch.Tensor:
    """(B, T) prefix mask -> its (B,) lengths, int64 on the CPU (one device
    sync); anything but a per-sample prefix mask of ``shape`` raises."""
    if valid.shape != shape:
        raise ValueError(f"lstm: valid must be (B, T) = {tuple(shape)}, got {tuple(valid.shape)}")
    valid = valid.bool()
    lengths = valid.sum(1)
    prefix = torch.arange(shape[1], device=valid.device)[None] < lengths[:, None]
    if not torch.equal(prefix, valid):
        raise ValueError("lstm: valid must be a prefix mask per sample (valid frames first)")
    return lengths.cpu()


def lstm(x, module: nn.LSTM, *, valid=None, lengths=None):
    """x: (B, T, in) -> (B, T, H·directions), zero initial state. valid:
    optional (B, T) prefix mask; masked steps emit zeros and leave the
    state alone (module docstring); ``lengths``: its ``_lengths``, where
    the caller holds them already."""
    if valid is None:
        return module(x)[0]
    if lengths is None:
        lengths = _lengths(valid, x.shape[:2])
    packed = pack_padded_sequence(x, lengths.clamp_min(1), batch_first=True,
                                  enforce_sorted=False)
    out = pad_packed_sequence(module(packed)[0], batch_first=True, total_length=x.shape[1])[0]
    return out * valid[:, :, None].to(out.dtype)


def res_lstm(x, module: nn.LSTM, *, valid=None):
    """ResLSTM: x (B, F, T) -> (B, F, T), with the residual skip; with
    ``valid``, masked frames come out zero, skip included. One ``lstm.res``
    span (``utils/trace.py``) around the recurrence and the skip, with its
    device time, opened once the lengths' sync is behind it."""
    xt = x.transpose(1, 2)
    lengths = None if valid is None else _lengths(valid, xt.shape[:2])
    with trace.span("lstm.res", x.device):
        y = lstm(xt, module, valid=valid, lengths=lengths) + xt
        if valid is not None:
            y = y * valid[:, :, None].to(y.dtype)
        return y.transpose(1, 2).contiguous()


def res_lstm_streaming(x, module: nn.LSTM, state, *, valid=None):
    """One chunk of a one-way ResLSTM stream: x (B, F, T), ``state`` the
    per-layer list of (h, c), each (B, H), or None for the zero start ->
    (y (B, F, T), new state). Equal to ``res_lstm`` over the whole stream.
    valid: optional (T,) suffix mask, the frames that exist in the stream
    (the anti-aliased stream's warm-up frames come first): the frames before
    it leave the state untouched and come out zero, skip included."""
    if module.bidirectional:
        raise ValueError("res_lstm_streaming: the LSTM must be one-way")
    xt = x.transpose(1, 2)
    B, T, _ = xt.shape
    skip = 0
    if valid is not None:
        valid = torch.as_tensor(valid, device="cpu").bool()
        skip = T - int(valid.sum())
        if valid.shape != (T,) or valid[:skip].any():
            raise ValueError(f"res_lstm_streaming: valid must be a ({T},) suffix mask")
    if state is None:
        h = xt.new_zeros(module.num_layers, B, module.hidden_size)
        h0, c0 = h, h
    else:
        h0 = torch.stack([h for h, _ in state]).to(xt.dtype)
        c0 = torch.stack([c for _, c in state]).to(xt.dtype)
    if skip == T:
        return torch.zeros_like(x), list(zip(h0.unbind(0), c0.unbind(0)))
    y, (hn, cn) = module(xt[:, skip:], (h0, c0))
    y = torch.cat([xt.new_zeros(B, skip, y.shape[-1]), y + xt[:, skip:]], dim=1)
    return y.transpose(1, 2).contiguous(), list(zip(hn.unbind(0), cn.unbind(0)))


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
