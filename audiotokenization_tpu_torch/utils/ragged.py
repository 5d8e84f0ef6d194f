"""Ragged batches: variable-length files through the codec in one call
(counterpart of ``audiotokenization_tpu/utils/ragged.py``, BigCodec only).

Files of unequal length go in as one zero-padded batch with their lengths.
A longer zero tail would move where each conv layer's zero padding begins,
so ``_edge_mask`` zeroes each sample's positions past its own length after
every conv, ResidualUnit and transpose conv, and the ResLSTM takes a
per-sample prefix mask (``ops/lstm.py``). Anti-aliased configs need more:
each Activation1d replicate-pads at the file's own edge, so ``_MaskedAA``
replicates each sample's tail from its last valid position before the 2x
upsample and again before the 2x downsample, then re-zeroes it. Each
sample then computes what it computes alone: tokens equal to the per-file
``tokenize`` / ``forward``, waveforms to fp32 rounding
(``tests/test_torch_ragged.py``, ``tests/test_torch_causal.py``). A fused
ResidualUnit is one launch of K2 and the VQ one launch of K1 on CUDA
tensors, as in ``models/codec.py``.

Ported: the BigCodec encoder and decoder with the factorized VQ, plain,
causal, anti-aliased or both, for the reconstruction (``make_ragged_codec``,
the eval and test passes) and the tokenizer in every tokenize mode
(``make_ragged_tokenizer``, corpus extraction; ``balanced`` splits at
``_conv_front`` / ``_finish_masked``, as JAX does). The Conformer and
semantic configurations and the other quantizers raise
``NotImplementedError``.
"""
from __future__ import annotations

import math

import torch

from ..config import Config
from ..models import bigcodec
from ..models.codec import (MODES, encode_in_mode, full_fp32, precision_scope, quantize,
                            resolve_device)
from ..ops.alias_free import downsample1d, resample_filter, upsample1d
from ..ops.lstm import res_lstm
from ..ops.snake import snake_beta


def _check_supported(cfg: Config):
    e, d = cfg.model.codec_encoder, cfg.model.codec_decoder
    for part, name in ((e, "encoder"), (d, "decoder")):
        if part.type != "bigcodec":
            raise NotImplementedError(
                f"no ragged path for the {name} type {part.type!r} yet: the Conformer "
                "family comes with its own slice (ROADMAP Queue 1 item 13)")
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


def _replicate_tail(x, bound):
    """Each sample's positions >= bound take the value at bound - 1 (the
    per-file replicate padding of Activation1d's filters). x (B, C, L);
    bound (B,) int."""
    idx = torch.minimum(torch.arange(x.shape[-1], device=x.device)[None, :],
                        bound.clamp_min(1)[:, None] - 1)
    return torch.gather(x, 2, idx[:, None, :].expand(-1, x.shape[1], -1))


class _MaskedAA:
    """Activation1d with per-sample tails. Without anti-aliasing a plain
    snake (snake(0) = 0 keeps the zero tail). With it: replicate the tail,
    2x upsample, snake, replicate the upsampled tail (the per-file
    downsample pads with the edge value, not the interpolation past it),
    2x downsample, then re-zero the tail for the next conv's zero padding.
    bound: (B,) valid positions at this stride scale."""

    def __init__(self, antialias: bool, bound):
        self._aa = bigcodec._AA(antialias)
        self.antialias = antialias
        self.bound = bound

    def __call__(self, x, snake):
        if not self.antialias:
            return self._aa(x, snake)
        filt = resample_filter(2, x.device, x.dtype)
        b = self.bound
        x = upsample1d(_replicate_tail(x, b), filt, 2)
        x = snake_beta(x, snake.alpha, snake.beta)
        x = downsample1d(_replicate_tail(x, 2 * b), filt, 2)
        return _edge_mask(x, b)


def _aa_factory(part, lengths):
    """Activation1d at stride scale S for ``part`` (encoder or decoder)."""
    return lambda S: _MaskedAA(part.antialias, lengths // S)


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
    aa_at = _aa_factory(enc, lengths)
    x = bigcodec._wn_conv(x, enc.conv_in, padding=3, causal=enc.causal)
    S = 1
    x = _edge_mask(x, lengths)
    for block, stride in zip(enc.blocks, enc.up_ratios):
        aa = aa_at(S)
        for unit, d in zip(block.units, enc.dilations):
            x = _edge_mask(bigcodec.residual_unit(x, unit, dilation=d, aa=aa), lengths // S)
        x = aa(x, block.snake)
        if stride != 1:
            x = bigcodec._wn_conv(x, block.down, stride=stride,
                                  padding=stride // 2 + stride % 2, causal=enc.causal)
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
    lat = _MaskedAA(enc.antialias, frames)(lat, enc.snake_out)
    return bigcodec._wn_conv(lat, enc.conv_out, padding=1, causal=enc.causal)


def _encode_masked(enc: bigcodec.BigCodecEncoder, wavs, lengths, hop: int):
    """wavs (B, L) zero-padded, lengths (B,) samples -> latents (B, C, L / hop);
    frames past lengths // hop are meaningless."""
    return _finish_masked(enc, _conv_front(enc, wavs[:, None, :], lengths), lengths, hop)


def _decode_masked_bigcodec(dec: bigcodec.BigCodecDecoder, z, frames):
    """The decoder with per-sample frame bounds: ``bigcodec_decode`` with
    each sample's tail re-zeroed after every spatial op. z (B, C, L) ->
    (B, 1, L · hop)."""
    x = _edge_mask(bigcodec._wn_conv(z, dec.conv_in, padding=3, causal=dec.causal), frames)
    if dec.lstm is not None:
        x = res_lstm(x, dec.lstm, valid=_frame_valid(frames, x.shape[-1]))
        x = _edge_mask(x, frames)
    S = 1
    for block, stride in zip(dec.blocks, dec.up_ratios):
        x = _MaskedAA(dec.antialias, frames * S)(x, block.snake)
        if stride != 1:
            x = bigcodec._wn_tconv(x, block.up, stride=stride, padding=stride // 2 + stride % 2,
                                   output_padding=stride % 2, causal=dec.causal)
        else:
            x = bigcodec._wn_tconv(x, block.up)
        S *= stride
        x = _edge_mask(x, frames * S)
        aa = _MaskedAA(dec.antialias, frames * S)
        for unit, d in zip(block.units, dec.dilations):
            x = _edge_mask(bigcodec.residual_unit(x, unit, dilation=d, aa=aa), frames * S)
    x = _MaskedAA(dec.antialias, frames * S)(x, dec.snake_out)
    x = bigcodec._wn_conv(x, dec.conv_out, padding=3, causal=dec.causal)
    return torch.tanh(x)


def make_ragged_tokenizer(cfg: Config, *, mode: str = "conformant", device="cuda"):
    """Batched variable-length tokenization: ``run(codec, wavs, lengths)``
    with wavs (B, L) float32 or int16 PCM, zero-padded, and lengths (B,) in
    samples, returns codes (Nq, B, L // hop) on ``device`` (the codec's);
    frames past lengths // hop are meaningless (trim per sample). Each row's
    tokens equal the per-file ``tokenize`` of its own hop-padded samples,
    in the same ``mode`` (``models/codec.py::encode_in_mode``; the VQ is
    fp32 with TF32 off), without gradients. Raises without a card unless
    ``device="cpu"``."""
    device = resolve_device(device)
    if mode not in MODES:
        raise ValueError(f"unknown tokenize mode {mode!r}")
    _check_supported(cfg)
    hop = math.prod(cfg.model.codec_encoder.up_ratios)

    def run(codec, wavs, lengths):
        wavs = _maybe_pcm16(torch.as_tensor(wavs, device=device)).float()
        lengths = torch.as_tensor(lengths, device=device).long()
        enc = codec.encoder
        lat = encode_in_mode(enc, wavs[:, None, :], mode,
                             front=lambda x: _conv_front(enc, x, lengths),
                             tail=lambda y: _finish_masked(enc, y, lengths, hop))
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
