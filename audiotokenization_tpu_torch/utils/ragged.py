"""Ragged batches: variable-length files through the codec in one call
(counterpart of ``audiotokenization_tpu/utils/ragged.py``).

Files of unequal length go in as one zero-padded batch with their lengths
(samples), and each family's ``forward`` takes them: BigCodec re-zeroes
each sample's tail after every spatial op and masks its ResLSTM, with
per-file edges for anti-aliasing (``models/bigcodec.py``); the Conformer's
STFT front is exact without a mask (its constant zero padding is the
batch's zero tail), its backbone takes the frame counts (attention masks
the pad keys, the conv module zeroes the pad frames before its depthwise
conv) and its ISTFT gives each sample its own envelope
(``models/conformer.py``). Each sample then computes what it computes
alone: tokens equal to the per-file ``tokenize`` / ``forward``, waveforms
to fp32 rounding (``tests/test_torch_ragged.py``, ``tests/test_torch_causal.py``,
``tests/test_torch_conformer_stream.py``). A fused ResidualUnit is one
launch of K2 and the VQ one launch of K1 on CUDA tensors, as in
``models/codec.py``.

Ported: what ``Codec`` builds (``models/codec.py::check_config``), for the
reconstruction (``make_ragged_codec``, the eval and test passes) and the
tokenizer (``make_ragged_tokenizer``, corpus extraction) in each tokenize
mode of the encoder (``balanced`` splits BigCodec at its ``stages``, as
JAX does, and has no Conformer form). FSQ quantizes frame by frame, so it
is exact here as the VQ is. A Conformer with ``ffn_type: moe`` on either
side raises ``NotImplementedError``, as in the JAX package: expert
capacity is a function of the batch's token count and tokens compete for
slots across samples, so a batched result can never equal per-file
processing (evaluate such a codec per file).
"""
from __future__ import annotations

import torch

from ..config import Config, codec_hop
from ..models.bigcodec import edge_mask
from ..models.codec import (ENCODERS, check_config, check_mode, encode_in_mode, full_fp32,
                            precision_scope, quantize, resolve_device)


def check_exactness(cfg: Config):
    """``NotImplementedError`` for a config whose batched result is not the
    per-file one (the MoE feed-forward, module docstring)."""
    for part, name in ((cfg.model.codec_encoder, "encoder"), (cfg.model.codec_decoder, "decoder")):
        if part.type != "bigcodec" and part.ffn_type == "moe":
            raise NotImplementedError(f"ffn_type: moe {name}: capacity routing is batch-global; "
                                      "no exact ragged path (evaluate per file)")


def _maybe_pcm16(wavs):
    """int16 PCM -> float32 on the device; int16 / 32768 is exact in float32,
    so this equals ``data.audio_io.read_wav``'s host conversion bit for bit."""
    if wavs.dtype == torch.int16:
        return wavs.float() / 32768.0
    return wavs


def make_ragged_tokenizer(cfg: Config, *, mode: str = "conformant", device="cuda"):
    """Batched variable-length tokenization: ``run(codec, wavs, lengths)``
    with wavs (B, L) float32 or int16 PCM, zero-padded, and lengths (B,) in
    samples, returns codes (Nq, B, L // hop) on ``device`` (the codec's;
    Nq: ``config.num_codebooks``); frames past lengths // hop are
    meaningless (trim per sample). Each row's tokens equal the per-file
    ``tokenize`` of its own hop-padded samples, in the same ``mode``
    (``models/codec.py::encode_in_mode``; the quantizer is fp32 with TF32
    off), without gradients. Raises without a card unless
    ``device="cpu"``."""
    device = resolve_device(device)
    check_config(cfg)
    check_exactness(cfg)
    check_mode(ENCODERS[cfg.model.codec_encoder.type], mode)

    def run(codec, wavs, lengths):
        wavs = _maybe_pcm16(torch.as_tensor(wavs, device=device)).float()
        lengths = torch.as_tensor(lengths, device=device).long()
        lat = encode_in_mode(codec.encoder, wavs[:, None, :], mode, lengths=lengths)
        with torch.no_grad(), full_fp32():
            _, codes, _ = quantize(codec, lat)
        return codes

    return run


def make_ragged_codec(cfg: Config, *, device="cuda"):
    """Batched variable-length reconstruction: ``run(codec, wavs, lengths)``
    with wavs (B, L) float32 or int16 PCM, zero-padded, and lengths (B,) in
    samples, returns (recon (B, L), codes (Nq, B, L // hop)) on ``device``
    (the codec's); frames past lengths // hop are meaningless. Runs without
    gradients under ``precision_scope(cfg)``, as ``forward`` evaluates.
    Raises without a card unless ``device="cpu"``."""
    device = resolve_device(device)
    check_config(cfg)
    check_exactness(cfg)
    hop = codec_hop(cfg)

    def run(codec, wavs, lengths):
        wavs = _maybe_pcm16(torch.as_tensor(wavs, device=device))
        lengths = torch.as_tensor(lengths, device=device).long()
        frames = lengths // hop
        with torch.no_grad(), precision_scope(cfg):
            zq, codes, _ = quantize(codec, codec.encoder(wavs[:, None, :], lengths=lengths))
            recon = codec.decoder(edge_mask(zq, frames), frames=frames)
        return recon[:, 0], codes

    return run
