"""Ragged batches: variable-length files through the codec in one call
(counterpart of ``audiotokenization_tpu/utils/ragged.py``, BigCodec only).

Files of unequal length go in as one zero-padded batch with their lengths.
A longer zero tail would move where each conv layer's zero padding begins,
so ``_edge_mask`` zeroes each sample's positions past its own length after
every conv, ResidualUnit and transpose conv, and the ResLSTM takes a
per-sample prefix mask (``ops/lstm.py``). Each sample then computes what
it computes alone: tokens equal to the per-file ``forward``, waveforms to
fp32 rounding (``tests/test_torch_ragged.py``). On CUDA tensors every
ResidualUnit is one launch of K2 and the VQ one launch of K1, as in
``models/codec.py``.

Ported: the non-causal, non-anti-aliased BigCodec encoder and decoder with
the factorized VQ, both the reconstruction (``make_ragged_codec``, the eval
and test passes) and the conformant tokenizer (``make_ragged_tokenizer``,
corpus extraction). The Conformer, causal, anti-aliased and semantic
configurations raise ``NotImplementedError``, as do the tokenize modes
``high``, ``balanced`` and ``fast``.
"""
from __future__ import annotations

import math

import torch

from ..config import Config
from ..models import bigcodec
from ..models.codec import full_fp32, precision_scope, quantize, resolve_device
from ..ops.lstm import res_lstm


def _check_supported(cfg: Config):
    e, d = cfg.model.codec_encoder, cfg.model.codec_decoder
    for part, name in ((e, "encoder"), (d, "decoder")):
        if part.type != "bigcodec":
            raise NotImplementedError(
                f"no ragged path for the {name} type {part.type!r} yet: the Conformer "
                "family comes with its own slice (ROADMAP Queue 1 item 13)")
        if part.causal or part.antialias:
            raise NotImplementedError(
                f"no ragged path for a causal or anti-aliased {name} yet: it comes with "
                "the causal and streaming slice (ROADMAP Queue 1 item 12)")
    if cfg.train.use_semantic:
        raise NotImplementedError("no ragged path for the semantic branch yet "
                                  "(ROADMAP Queue 1 item 15)")
    if (d.quantizer, d.fsq) != ("fvq", False):
        raise NotImplementedError(f"no ragged path for the {d.quantizer!r} quantizer yet "
                                  "(ROADMAP Queue 1 item 14)")


def _edge_mask(x, bound):
    """Zero each sample's positions >= bound. x (B, C, L); bound (B,) int,
    at x's stride scale."""
    g = torch.arange(x.shape[-1], device=x.device)
    return x * (g[None, :] < bound[:, None])[:, None, :].to(x.dtype)


def _frame_valid(frames, T: int):
    """(B,) frame counts -> (B, T) bool mask."""
    return torch.arange(T, device=frames.device)[None, :] < frames[:, None]


def _maybe_pcm16(wavs):
    """int16 PCM -> float32 on the device; int16 / 32768 is exact in float32,
    so this equals ``data.audio_io.read_wav``'s host conversion bit for bit."""
    if wavs.dtype == torch.int16:
        return wavs.float() / 32768.0
    return wavs


def _conv_front(enc: bigcodec.BigCodecEncoder, x, lengths):
    """The encoder's conv stack (conv_in and the blocks, no LSTM or tail),
    with each sample's tail re-zeroed after every conv and unit.
    x: (B, 1, L) -> (B, C, L / hop)."""
    x = bigcodec._wn_conv(x, enc.conv_in, padding=3)
    S = 1
    x = _edge_mask(x, lengths)
    for block, stride in zip(enc.blocks, enc.up_ratios):
        for unit, d in zip(block.units, enc.dilations):
            x = _edge_mask(bigcodec.residual_unit(x, unit, dilation=d), lengths // S)
        x = block.snake(x)
        if stride != 1:
            x = bigcodec._wn_conv(x, block.down, stride=stride, padding=stride // 2 + stride % 2)
        else:
            x = bigcodec._wn_conv(x, block.down)
        S *= stride
        x = _edge_mask(x, lengths // S)
    return x


def _finish_masked(enc: bigcodec.BigCodecEncoder, lat, lengths, hop: int):
    """ResLSTM and the encoder's tail over the conv front's latents."""
    frames = lengths // hop
    if enc.lstm is not None:
        lat = res_lstm(lat, enc.lstm, valid=_frame_valid(frames, lat.shape[-1]))
    lat = _edge_mask(lat, frames)  # the tail conv reads past each sample's last frame
    return bigcodec._wn_conv(enc.snake_out(lat), enc.conv_out, padding=1)


def _encode_masked(enc: bigcodec.BigCodecEncoder, wavs, lengths, hop: int):
    """wavs (B, L) zero-padded, lengths (B,) samples -> latents (B, C, L / hop);
    frames past lengths // hop are meaningless."""
    return _finish_masked(enc, _conv_front(enc, wavs[:, None, :], lengths), lengths, hop)


def _decode_masked_bigcodec(dec: bigcodec.BigCodecDecoder, z, frames):
    """The decoder with per-sample frame bounds: ``bigcodec_decode`` with
    each sample's tail re-zeroed after every spatial op. z (B, C, L) ->
    (B, 1, L · hop)."""
    x = _edge_mask(bigcodec._wn_conv(z, dec.conv_in, padding=3), frames)
    if dec.lstm is not None:
        x = res_lstm(x, dec.lstm, valid=_frame_valid(frames, x.shape[-1]))
        x = _edge_mask(x, frames)
    S = 1
    for block, stride in zip(dec.blocks, dec.up_ratios):
        x = block.snake(x)
        if stride != 1:
            x = bigcodec._wn_tconv(x, block.up, stride=stride, padding=stride // 2 + stride % 2,
                                   output_padding=stride % 2)
        else:
            x = bigcodec._wn_tconv(x, block.up)
        S *= stride
        x = _edge_mask(x, frames * S)
        for unit, d in zip(block.units, dec.dilations):
            x = _edge_mask(bigcodec.residual_unit(x, unit, dilation=d), frames * S)
    x = bigcodec._wn_conv(dec.snake_out(x), dec.conv_out, padding=3)
    return torch.tanh(x)


def make_ragged_tokenizer(cfg: Config, *, mode: str = "conformant", device="cuda"):
    """Batched variable-length tokenization: ``run(codec, wavs, lengths)``
    with wavs (B, L) float32 or int16 PCM, zero-padded, and lengths (B,) in
    samples, returns codes (Nq, B, L // hop) on ``device`` (the codec's);
    frames past lengths // hop are meaningless (trim per sample). Each row's
    tokens equal the per-file ``tokenize`` of its own hop-padded samples.
    Conformant mode only: full fp32, TF32 off, without gradients. Raises
    without a card unless ``device="cpu"``."""
    device = resolve_device(device)
    if mode in ("high", "balanced", "fast"):
        raise NotImplementedError(f"ragged tokenize mode {mode!r} is not ported yet "
                                  "(ROADMAP Queue 1 item 6)")
    if mode != "conformant":
        raise ValueError(f"unknown tokenize mode {mode!r}")
    _check_supported(cfg)
    hop = math.prod(cfg.model.codec_encoder.up_ratios)

    def run(codec, wavs, lengths):
        wavs = _maybe_pcm16(torch.as_tensor(wavs, device=device)).float()
        lengths = torch.as_tensor(lengths, device=device).long()
        with torch.no_grad(), full_fp32():
            _, codes, _ = quantize(codec, _encode_masked(codec.encoder, wavs, lengths, hop))
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
    _check_supported(cfg)
    hop = math.prod(cfg.model.codec_encoder.up_ratios)

    def run(codec, wavs, lengths):
        wavs = _maybe_pcm16(torch.as_tensor(wavs, device=device))
        lengths = torch.as_tensor(lengths, device=device).long()
        frames = lengths // hop
        with torch.no_grad(), precision_scope(cfg):
            lat = _encode_masked(codec.encoder, wavs, lengths, hop)
            zq, codes, _ = quantize(codec, lat)
            recon = _decode_masked_bigcodec(codec.decoder, _edge_mask(zq, frames), frames)
        return recon[:, 0], codes

    return run
