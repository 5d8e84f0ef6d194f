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

A semantic codec's ``semantic_vq_in`` (fc_prior) is per frame; under
``concat_semantic`` its bottleneck's k3 convs zero each sample's tail
after every conv, and the teacher's ``semantic_target`` (B, 1024, L // hop)
is zeroed past each file's frames, which is what the per-file path's zero
padding of the teacher gives (``models/semantic.py::semantic_vq_in``).
The codec's decoder then takes ``apply_fc_post_a`` of the quantized
latents.
"""
from __future__ import annotations

import torch

from ..config import Config, codec_hop
from ..models.bigcodec import edge_mask
from ..models.codec import (ENCODERS, apply_fc_post_a, check_config, check_mode,
                            encode_in_mode, full_fp32, precision_scope, quantize,
                            resolve_device, semantic_vq_in)
from . import trace


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


def _target(semantic_target, device):
    if semantic_target is None:
        return None
    return torch.as_tensor(semantic_target, device=device).float()


def make_ragged_tokenizer(cfg: Config, *, mode: str = "conformant", device="cuda"):
    """Batched variable-length tokenization: ``run(codec, wavs, lengths,
    semantic_target=None)`` with wavs (B, L) float32 or int16 PCM,
    zero-padded, lengths (B,) in samples and, for a ``concat_semantic``
    codec, the teacher's (B, 1024, L // hop) zero past each file's frames,
    returns codes (Nq, B, L // hop) on ``device`` (the codec's;
    Nq: ``config.num_codebooks``); frames past lengths // hop are
    meaningless (trim per sample). Each row's tokens equal the per-file
    ``tokenize`` of its own hop-padded samples, in the same ``mode``
    (``models/codec.py::encode_in_mode``; the quantizer is fp32 with TF32
    off), without gradients. Raises without a card unless
    ``device="cpu"``. Each call is one ``ragged.call`` span
    (``utils/trace.py``)."""
    device = resolve_device(device)
    check_config(cfg)
    check_exactness(cfg)
    check_mode(ENCODERS[cfg.model.codec_encoder.type], mode)
    hop = codec_hop(cfg)

    def run(codec, wavs, lengths, semantic_target=None):
        with trace.span("ragged.call"):
            wavs = _maybe_pcm16(torch.as_tensor(wavs, device=device)).float()
            lengths = torch.as_tensor(lengths, device=device).long()
            lat = encode_in_mode(codec.encoder, wavs[:, None, :], mode, lengths=lengths)
            with torch.no_grad(), full_fp32():
                lat = semantic_vq_in(codec, lat, _target(semantic_target, device),
                                     frames=lengths // hop)
                _, codes, _ = quantize(codec, lat)
            return codes

    return run


def make_ragged_codec(cfg: Config, *, device="cuda"):
    """Batched variable-length reconstruction: ``run(codec, wavs, lengths,
    semantic_target=None)`` with wavs (B, L) float32 or int16 PCM,
    zero-padded, lengths (B,) in samples and the teacher's as for
    ``make_ragged_tokenizer``, returns (recon (B, L), codes (Nq, B, L //
    hop)) on ``device`` (the codec's); frames past lengths // hop are
    meaningless. Runs without
    gradients under ``precision_scope(cfg)``, as ``forward`` evaluates.
    Raises without a card unless ``device="cpu"``."""
    device = resolve_device(device)
    check_config(cfg)
    check_exactness(cfg)
    hop = codec_hop(cfg)

    def run(codec, wavs, lengths, semantic_target=None):
        wavs = _maybe_pcm16(torch.as_tensor(wavs, device=device))
        lengths = torch.as_tensor(lengths, device=device).long()
        frames = lengths // hop
        with torch.no_grad(), precision_scope(cfg):
            lat = semantic_vq_in(codec, codec.encoder(wavs[:, None, :], lengths=lengths),
                                 _target(semantic_target, device), frames=frames)
            zq, codes, _ = quantize(codec, lat)
            zq = apply_fc_post_a(codec, zq)
            recon = codec.decoder(edge_mask(zq, frames), frames=frames)
        return recon[:, 0], codes

    return run
