"""Streaming tokenization and synthesis for causal BigCodec configs.

Counterpart of ``audiotokenization_tpu/models/streaming.py`` (the BigCodec
half: ``StreamingTokenizer``, ``StreamingSynthesizer``, ``stream_decode``).
A ``step`` takes one chunk and emits its tokens (or samples) with the same
values as the offline ``tokenize`` (or ``decode``) of the whole stream.

The tokenizer carries between steps:
- ``sample_tail``: the last input samples, as many as the causal conv
  stack's receptive field, re-fed with each chunk so the stack's left zero
  padding never clips a live receptive field (the window's start stays
  hop-aligned, so stride phases match the whole stream);
- the ResLSTM's per-layer (h, c): one-way with unbounded memory, so carried,
  not replayed;
- ``frame_tail``: the last post-LSTM frames the causal k3 output conv (and,
  anti-aliased, the snake_out Activation1d) reads.

Anti-aliased configs: the Activation1d filters are symmetric, so a causal
anti-aliased codec depends on a bounded span of future samples. Such a
stream runs ``delay_frames`` frames behind: each step emits the span that
ended ``delay_frames`` earlier (the stream's first ``delay_frames`` tokens
are warm-up to discard), and ``flush`` drains the last ``delay_frames``
with the stream's true end, where the filters replicate-pad as offline.
The window's true edges go through ``parallel/sp.py::_SPAA``. A stream is
at most 2**28 samples (``_NO_END``, the "no right edge yet" bound).

Every step runs in fp32 with TF32 off and without gradients, and makes one
launch of K1 (the VQ) on the card. A causal unit is not K2's
(``models/bigcodec.py``), so the streaming paths launch no K2. The
Conformer's streaming classes are ROADMAP Queue 1 item 13.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from ..ops.lstm import res_lstm_streaming
from ..parallel.sp import _AA_REACH, _SPAA
from . import bigcodec
from .codec import (Codec, apply_fc_post_a, codes_to_emb, full_fp32, quantize,
                    resolve_device)

_NO_END = 2 ** 28    # mid-stream bound in samples: the right edge is not here yet
_NO_END_F = 2 ** 20  # the same in frames, for the synthesizer


def _refuse_conformer(part):
    if part.type != "bigcodec":
        raise NotImplementedError(
            f"no streaming path for the {part.type!r} family yet: the Conformer's "
            "streaming classes come with ROADMAP Queue 1 item 13")


class StreamState(NamedTuple):
    sample_tail: torch.Tensor   # (B, 1, tail) samples
    lstm_state: Any             # per layer (h, c), each (B, H)
    frame_tail: torch.Tensor    # (B, C, 2 [+ _AA_REACH]) post-LSTM frames
    pos: int = 0                # samples consumed so far


def _front_receptive_field(cfg) -> int:
    """Receptive field (samples) of the causal conv_in and encoder blocks;
    anti-aliased, with each Activation1d's filter reach at its scale (as
    ``utils/chunked.py::receptive_field_samples``)."""
    e = cfg.model.codec_encoder
    aa = 16 if e.antialias else 0
    rf, stride_prod = 7, 1
    for s in e.up_ratios:
        rf += stride_prod * (sum((7 - 1) * d for d in e.dilations) + 2 * s
                             + aa * (2 * len(e.dilations) + 1))
        stride_prod *= s
    return rf


def _front_future_reach(cfg) -> int:
    """One-sided future reach (samples) of the conv front's Activation1d
    filters; 0 without anti-aliasing (causal convs look left only)."""
    e = cfg.model.codec_encoder
    if not e.antialias:
        return 0
    ff, stride_prod = 0, 1
    for s in e.up_ratios:
        ff += stride_prod * _AA_REACH * (2 * len(e.dilations) + 1)
        stride_prod *= s
    return ff


def _lstm_step(module, x, state, valid=None):
    """The ResLSTM's streaming step, or nothing for a codec without one."""
    if module is None:
        return x, state
    return res_lstm_streaming(x, module, state, valid=valid)


class StreamingTokenizer:
    """Chunk-by-chunk tokenizer for a ``causal: true`` BigCodec ``codec`` on
    ``device`` (the card unless ``device="cpu"``; raises without one)."""

    def __init__(self, codec: Codec, *, chunk_samples: int, device="cuda"):
        self.device = resolve_device(device)
        e = codec.cfg.model.codec_encoder
        _refuse_conformer(e)
        if not e.causal or e.rnn_bidirectional:
            raise ValueError("streaming requires a causal unidirectional bigcodec "
                             "encoder config")
        self.codec, self.cfg = codec, codec.cfg
        self.hop = math.prod(e.up_ratios)
        if chunk_samples % self.hop != 0:
            raise ValueError(f"chunk_samples must be a multiple of hop {self.hop}")
        self.chunk = chunk_samples
        self.antialias = e.antialias
        if e.antialias:
            self._m = _AA_REACH  # snake_out's Activation1d reach, in frames
            # latency: the conv front's future taps, the frame-scale tail
            # Activation1d and one frame of guard at the window's edge
            self.delay_frames = (self._m + 1
                                 + -(-_front_future_reach(self.cfg) // self.hop))
        else:
            self._m = 0
            self.delay_frames = 0
        rf = _front_receptive_field(self.cfg)
        self.tail = -(-rf // self.hop) * self.hop + self.delay_frames * self.hop

    def init_state(self, batch_size: int = 1) -> StreamState:
        e = self.cfg.model.codec_encoder
        enc_dim = e.ngf * 2 ** len(e.up_ratios)
        zeros = lambda *s: torch.zeros(*s, device=self.device)  # noqa: E731
        return StreamState(
            sample_tail=zeros(batch_size, 1, self.tail),
            lstm_state=[(zeros(batch_size, enc_dim), zeros(batch_size, enc_dim))
                        for _ in range(e.rnn_num_layers)],
            frame_tail=zeros(batch_size, enc_dim, 2 + self._m),
            pos=0)

    def step(self, state: StreamState, chunk, end: int = _NO_END):
        """chunk (B, chunk_samples) -> (codes (Nq, B, chunk / hop), new state).

        Without anti-aliasing the codes are this chunk's frames; with it the
        span ``delay_frames`` earlier. ``end``: the stream's true length in
        samples once known (``flush``)."""
        chunk = torch.as_tensor(chunk, dtype=torch.float32, device=self.device)
        with torch.no_grad(), full_fp32():
            codes, new_state = self._step(state, chunk, end)
        return codes, new_state

    def _step(self, state: StreamState, chunk, end: int):
        enc = self.codec.encoder
        nf = self.chunk // self.hop
        window = torch.cat([state.sample_tail, chunk[:, None, :]], dim=2)
        x = bigcodec._wn_conv(window, enc.conv_in, causal=True)
        if not self.antialias:
            aa = bigcodec._AA(False)
            for block, stride in zip(enc.blocks, enc.up_ratios):
                x = bigcodec.encoder_block(x, block, stride=stride, dilations=enc.dilations,
                                           aa=aa)
            x = x[:, :, -nf:]  # exact: the receptive field lies inside the window
            x, lstm_state = _lstm_step(enc.lstm, x, state.lstm_state)
            y = aa(torch.cat([state.frame_tail, x], dim=2), enc.snake_out)
            lat = bigcodec._wn_conv(y, enc.conv_out, causal=True)[:, :, -nf:]
            keep = x
        else:
            m, D = self._m, self.delay_frames
            pos0 = state.pos - self.tail  # global sample index of window[0]
            S = 1
            for block, stride in zip(enc.blocks, enc.up_ratios):
                x = bigcodec.encoder_block(x, block, stride=stride, dilations=enc.dilations,
                                           aa=_SPAA(True, pos0 // S, end // S))
                S *= stride
            # the emitted span starts at frame E = pos / hop - D, at the
            # window's static offset tail / hop - D
            a = self.tail // self.hop - D
            lat_a, lat_b = x[:, :, a:a + nf], x[:, :, a + nf:a + nf + m]
            E = state.pos // self.hop - D
            # frames before global 0 never existed: they leave the LSTM alone
            lat_a, lstm_state = _lstm_step(enc.lstm, lat_a, state.lstm_state,
                                           valid=E + torch.arange(nf) >= 0)
            lat_b, _ = _lstm_step(enc.lstm, lat_b, lstm_state,
                                  valid=E + nf + torch.arange(m) >= 0)
            post = torch.cat([state.frame_tail, lat_a, lat_b], dim=2)
            y = _SPAA(True, E - (2 + m), end // self.hop)(post, enc.snake_out)
            lat = bigcodec._wn_conv(y, enc.conv_out)[:, :, m:m + nf]
            keep = lat_a
        _, codes, _ = quantize(self.codec, lat)
        return codes, StreamState(
            sample_tail=window[:, :, -self.tail:],
            lstm_state=lstm_state,
            frame_tail=torch.cat([state.frame_tail, keep], dim=2)[:, :, -(2 + self._m):],
            pos=state.pos + self.chunk)

    def flush(self, state: StreamState):
        """Drain the ``delay_frames`` tokens still in the latency window,
        the stream having ended at ``state.pos`` samples: (codes (Nq, B,
        delay_frames), new state). 0 frames without anti-aliasing."""
        B = state.sample_tail.shape[0]
        if self.delay_frames == 0:
            nq = self.cfg.model.codec_decoder.vq_num_quantizers
            return torch.zeros(nq, B, 0, dtype=torch.int32, device=self.device), state
        end = state.pos
        zeros = torch.zeros(B, self.chunk, device=self.device)
        outs, got = [], 0
        while got < self.delay_frames:
            codes, state = self.step(state, zeros, end)
            outs.append(codes)
            got += self.chunk // self.hop
        return torch.cat(outs, dim=2)[:, :, :self.delay_frames], state


class SynthState(NamedTuple):
    latent_tail: torch.Tensor   # (B, C_in, 6): the decoder conv_in's k7 lookback
    lstm_state: Any             # per layer (h, c)
    post_tail: torch.Tensor     # (B, D, post) post-LSTM frames
    pos: int                    # frames decoded so far
    front_tail: torch.Tensor    # (B, D, delay_frames) pre-LSTM frames (anti-aliased)


def _zero_before_start(x, start: int):
    """x with its positions of negative global index (``start`` is the
    global index of x[..., 0]) set to 0: offline, causal convs zero-pad at
    every layer, and the transpose convs' biases would make the window's
    pre-stream region non-zero."""
    n = min(max(-start, 0), x.shape[-1])
    return torch.nn.functional.pad(x[..., n:], (n, 0)) if n else x


class StreamingSynthesizer:
    """Chunk-by-chunk decoder for a ``causal: true`` BigCodec ``codec`` on
    ``device`` (the card unless ``device="cpu"``; raises without one): the
    reverse of ``StreamingTokenizer``, equal to offline ``decode`` to fp32
    rounding. It carries the conv_in lookback latents, the ResLSTM's (h, c)
    and the last ``post`` post-LSTM frames, ``post`` covering the upsampling
    stack's left receptive field (accumulated per block below)."""

    def __init__(self, codec: Codec, *, chunk_frames: int, device="cuda"):
        self.device = resolve_device(device)
        d = codec.cfg.model.codec_decoder
        _refuse_conformer(d)
        if not d.causal or d.rnn_bidirectional:
            raise ValueError("streaming synthesis requires a causal unidirectional "
                             "bigcodec decoder config")
        self.codec, self.cfg = codec, codec.cfg
        self.chunk_frames = chunk_frames
        self.hop = math.prod(d.up_ratios)
        self.antialias = d.antialias
        m = _AA_REACH if d.antialias else 0
        self._m = m
        # the lookback of [blocks + tail conv] in post-LSTM frames, walking
        # the stack backwards: a block maps an output-scale reach r to
        # ceil((r + units' reach) / stride) + the tconv's 2 frames (+ the
        # block's Activation1d reach, anti-aliased)
        units = sum(6 * dd + 2 * m for dd in d.dilations)
        r = 6 + m  # conv_out k7 causal + snake_out
        for s in reversed(d.up_ratios):
            r = -(-(r + units) // s) + 2 + m
        self.post = r
        if d.antialias:
            # latency: the future reach of the symmetric filters through the
            # upsampling stack, in post-LSTM frames, + 1 guard frame
            units_f = 2 * m * len(d.dilations)
            rf = m
            for s in reversed(d.up_ratios):
                rf = -(-(rf + units_f) // s) + m
            self.delay_frames = rf + 1
        else:
            self.delay_frames = 0

    def init_state(self, batch_size: int = 1) -> SynthState:
        d = self.cfg.model.codec_decoder
        ch = d.upsample_initial_channel
        zeros = lambda *s: torch.zeros(*s, device=self.device)  # noqa: E731
        return SynthState(
            latent_tail=zeros(batch_size, d.in_channels, 6),
            lstm_state=[(zeros(batch_size, ch), zeros(batch_size, ch))
                        for _ in range(d.rnn_num_layers)],
            post_tail=zeros(batch_size, ch, self.post),
            pos=0,
            front_tail=zeros(batch_size, ch, self.delay_frames))

    def step(self, state: SynthState, codes, end: int = _NO_END_F):
        """codes (Nq, B, chunk_frames) int -> (wav (B, chunk_frames · hop),
        new state). Anti-aliased, the samples are those of the span
        ``delay_frames`` earlier; ``end``: the stream's true length in
        frames once known (``flush``)."""
        codes = torch.as_tensor(codes, device=self.device)
        with torch.no_grad(), full_fp32():
            return self._step(state, codes, end)

    def _step(self, state: SynthState, codes, end: int):
        dec = self.codec.decoder
        F_ = self.chunk_frames
        D = self.delay_frames
        emb = apply_fc_post_a(self.codec, codes_to_emb(self.codec, codes.permute(1, 2, 0)))
        window = torch.cat([state.latent_tail, emb], dim=2)
        x_new = bigcodec._wn_conv(window, dec.conv_in, causal=True)[:, :, -F_:]
        if not self.antialias:
            x, lstm_state = _lstm_step(dec.lstm, x_new, state.lstm_state)
            y = torch.cat([state.post_tail, x], dim=2)
            w0 = state.pos - self.post
            front_tail = state.front_tail
        else:
            E = state.pos - D
            both = torch.cat([state.front_tail, x_new], dim=2)
            x, lstm_state = _lstm_step(dec.lstm, both[:, :, :F_], state.lstm_state,
                                       valid=E + torch.arange(F_) >= 0)
            seg_b, _ = _lstm_step(dec.lstm, both[:, :, F_:], lstm_state,
                                  valid=E + F_ + torch.arange(D) >= 0)
            y = torch.cat([state.post_tail, x, seg_b], dim=2)
            w0 = E - self.post
            front_tail = both[:, :, F_:]
        scale = 1

        def aa_at(scale):
            return (_SPAA(True, w0 * scale, end * scale) if self.antialias
                    else bigcodec._AA(False))

        for block, stride in zip(dec.blocks, dec.up_ratios):
            y = aa_at(scale)(y, block.snake)
            if stride != 1:
                y = bigcodec._wn_tconv(y, block.up, stride=stride, causal=True)
            else:
                y = bigcodec._wn_tconv(y, block.up)
            scale *= stride
            y = _zero_before_start(y, w0 * scale)
            aa = aa_at(scale)
            for unit, dd in zip(block.units, dec.dilations):
                y = _zero_before_start(bigcodec.residual_unit(y, unit, dilation=dd, aa=aa),
                                       w0 * scale)
        y = aa_at(self.hop)(y, dec.snake_out)
        y = bigcodec._wn_conv(y, dec.conv_out, causal=True)
        if not self.antialias:
            wav = torch.tanh(y[:, :, -F_ * self.hop:])
        else:
            p0 = self.post * self.hop
            wav = torch.tanh(y[:, :, p0:p0 + F_ * self.hop])
        return wav[:, 0], SynthState(
            latent_tail=window[:, :, -6:],
            lstm_state=lstm_state,
            post_tail=torch.cat([state.post_tail, x], dim=2)[:, :, -self.post:],
            pos=state.pos + F_,
            front_tail=front_tail)

    def flush(self, state: SynthState):
        """Drain the ``delay_frames · hop`` samples still in the latency
        window, the code stream having ended at ``state.pos`` frames:
        (wav (B, delay_frames · hop), new state); empty without
        anti-aliasing."""
        B = state.latent_tail.shape[0]
        if self.delay_frames == 0:
            return torch.zeros(B, 0, device=self.device), state
        end = state.pos
        nq = self.cfg.model.codec_decoder.vq_num_quantizers
        zeros = torch.zeros(nq, B, self.chunk_frames, dtype=torch.long, device=self.device)
        outs, got = [], 0
        while got < self.delay_frames:
            wav, state = self.step(state, zeros, end)
            outs.append(wav)
            got += self.chunk_frames
        return torch.cat(outs, dim=1)[:, :self.delay_frames * self.hop], state


def stream_decode(codec: Codec, codes, *, chunk_frames: int, device="cuda"):
    """A whole code stream (Nq, B, T_frames) decoded chunk by chunk through
    ``StreamingSynthesizer`` -> (B, T_frames · hop) on ``device``, equal to
    offline ``decode`` to fp32 rounding. It discards the leading latency
    samples and drains the tail with ``flush``; a trailing partial chunk
    gets a synthesizer of its own size, to which the state carries over.
    What ``cli/synthesize.py --streaming`` runs, and the template of a live
    loop (feed chunks as they arrive)."""
    _refuse_conformer(codec.cfg.model.codec_decoder)
    syn = StreamingSynthesizer(codec, chunk_frames=chunk_frames, device=device)
    codes = torch.as_tensor(codes, device=syn.device)
    T, B = codes.shape[-1], codes.shape[1]
    state = syn.init_state(batch_size=B)
    pieces, t = [], 0
    while t + chunk_frames <= T:
        wav, state = syn.step(state, codes[:, :, t:t + chunk_frames])
        pieces.append(wav)
        t += chunk_frames
    if t < T:
        syn = StreamingSynthesizer(codec, chunk_frames=T - t, device=device)
        wav, state = syn.step(state, codes[:, :, t:])
        pieces.append(wav)
    tail, _ = syn.flush(state)
    pieces.append(tail)
    skip = syn.delay_frames * syn.hop
    return torch.cat(pieces, dim=1)[:, skip:skip + T * syn.hop]
