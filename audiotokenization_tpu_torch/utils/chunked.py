"""Chunked tokenization of long audio (counterpart of
``audiotokenization_tpu/utils/chunked.py``).

A long file goes through ``tokenize`` in fixed windows: each chunk padded
with ``context`` samples of real audio on both sides, the context frames
dropped after quantization. With a context of at least the encoder's
receptive field, the chunks' tokens equal the whole file's (a causal
encoder needs the left context only; the right one is then harmless).
Each window is one ``tokenize`` call: on the flagship, one launch of K1
and 15 of K2.
"""
from __future__ import annotations

import math

import torch

from ..models.codec import Codec, resolve_device, tokenize


def receptive_field_samples(cfg) -> int:
    """A conservative bound of the BigCodec encoder's receptive field, in
    samples. Anti-aliased, each Activation1d adds its filters' reach
    (the 2x up / 2x down pair, +-8 positions at its scale, see
    ``parallel/sp.py::_AA_REACH``): 2 per residual unit, 1 per block and the
    final snake_out, each counted at double reach for margin."""
    e = cfg.model.codec_encoder
    if e.type != "bigcodec":
        return 4 * e.n_fft
    aa = 16 if e.antialias else 0
    rf, stride_prod = 7, 1  # conv_in
    for s in e.up_ratios:
        # three residual units (k7, dilations up to 9) + the down conv k = 2s
        rf += stride_prod * (sum((7 - 1) * d for d in e.dilations) + 2 * s
                             + aa * (2 * len(e.dilations) + 1))
        stride_prod *= s
    return rf + stride_prod * (3 + aa)  # conv_out k3 + snake_out


def make_chunked_tokenizer(codec: Codec, *, chunk_seconds: float = 10.0,
                           context_seconds: float | None = None, device="cuda"):
    """``run(wav)``: a (T,) waveform -> codes (Nq, T // hop) int32 on
    ``device`` (the codec's: the card unless ``device="cpu"``; raises
    without one), one conformant ``tokenize`` call a window of
    ``chunk_seconds`` plus the context on both sides (by default the
    receptive field, rounded up to a whole hop)."""
    device = resolve_device(device)
    cfg = codec.cfg
    hop = math.prod(cfg.model.codec_encoder.up_ratios)
    chunk = int(chunk_seconds * cfg.dataset.sample_rate) // hop * hop
    if context_seconds is None:
        ctx = -(-receptive_field_samples(cfg) // hop) * hop
    else:
        ctx = int(context_seconds * cfg.dataset.sample_rate) // hop * hop
    c = ctx // hop

    def run(wav):
        wav = torch.as_tensor(wav, dtype=torch.float32).reshape(-1)
        T = wav.shape[0]
        total = -(-T // chunk) * chunk
        padded = torch.nn.functional.pad(wav, (ctx, ctx + total - T)).to(device)
        pieces = [tokenize(codec, padded[None, s:s + chunk + 2 * ctx])[:, 0, c:c + chunk // hop]
                  for s in range(0, total, chunk)]
        return torch.cat(pieces, dim=1)[:, :T // hop]

    return run


def tokenize_chunked(codec: Codec, wav, *, chunk_seconds: float = 10.0,
                     context_seconds: float | None = None, device="cuda"):
    """One call of ``make_chunked_tokenizer``; for a corpus, build the
    tokenizer once and call it per file."""
    return make_chunked_tokenizer(codec, chunk_seconds=chunk_seconds,
                                  context_seconds=context_seconds, device=device)(wav)
