"""Streaming tokenization and synthesis for causal codecs.

Counterpart of ``audiotokenization_tpu/models/streaming.py``: for causal
BigCodec configs ``StreamingTokenizer`` and ``StreamingSynthesizer``, for
causal Conformer configs ``StreamingConformerTokenizer`` and
``StreamingConformerSynthesizer``, and ``stream_decode`` for either. A
``step`` takes one chunk and emits its tokens (or samples) with the same
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

The Conformer is incremental but in two places, both carried: causal
attention keeps per-layer K/V caches (``max_seq_len + delay_frames``
rows), and the conv module's causal depthwise conv a (k - 1)-frame ring of
GLU outputs. Its STFT front looks (win - P - hop) samples ahead (P = (win
- hop) / 2), so the tokenizer runs ``delay_frames`` = ceil((win - P -
hop) / hop) frames behind (2 at configs/conformer.yaml) and ``flush``
drains them; the synthesizer carries the overlap-add numerator and the
window envelope and runs P samples behind. Attention reads only the cache
rows written so far (the JAX package attends all rows, the later ones
masked). A query whose rows are all masked (the tokenizer's warm-up
frames) averages the values (``ops/transformer.py``), so every state
stays finite. The caches are written in place (copying them would move
0.8 GB a step at 8 streams of configs/conformer.yaml), so a Conformer
state is single-use: a step from a state that was already stepped raises
``ValueError`` (``KVCaches.pos``) instead of reading a later step's rows.

Every step runs in fp32 with TF32 off and without gradients, and makes one
launch of K1 (the VQ) on the card; an FSQ codec (codes (1, B, T)) makes
none. A causal unit is not K2's
(``models/bigcodec.py``), and the Conformer has none, so the streaming
paths launch no K2.

A semantic codec streams when its quantizer reads the latents alone (no
``concat_semantic``): each step applies ``semantic_vq_in`` (fc_prior, per
frame) before the quantizer, and the synthesizers decode
``apply_fc_post_a`` of the codes' embeddings. A ``concat_semantic`` codec
raises ``NotImplementedError``: its tokens need the teacher's output per
frame.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from ..config import num_codebooks
from ..ops.conv import conv1d, get_weight, linear, pointwise
from ..ops.lstm import res_lstm_streaming
from ..ops.stft import hann_window, overlap_add, stft
from ..ops.transformer import attend, conv_module, feed_forward, masked_bias, qkv_heads, rms_norm
from ..parallel.sp import _AA_REACH, _SPAA
from . import bigcodec
from .codec import (Codec, apply_fc_post_a, codes_to_emb, full_fp32, quantize,
                    resolve_device, semantic_vq_in)
from .conformer import encode_features, encode_output, head_spectrum

_NO_END = 2 ** 28    # mid-stream bound in samples: the right edge is not here yet
_NO_END_F = 2 ** 20  # the same in frames, for the synthesizer


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
        if e.type != "bigcodec" or not e.causal or e.rnn_bidirectional:
            raise ValueError("streaming requires a causal unidirectional bigcodec "
                             "encoder config (a causal Conformer streams through "
                             "StreamingConformerTokenizer)")
        _refuse_concat_semantic(codec.cfg)
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
        _, codes, _ = quantize(self.codec, semantic_vq_in(self.codec, lat))
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
            nq = num_codebooks(self.cfg)
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
    stack's left receptive field (accumulated per block below). Any step
    may take another frame count than ``chunk_frames`` (the size of
    ``flush``'s steps)."""

    def __init__(self, codec: Codec, *, chunk_frames: int, device="cuda"):
        self.device = resolve_device(device)
        d = codec.cfg.model.codec_decoder
        if d.type != "bigcodec" or not d.causal or d.rnn_bidirectional:
            raise ValueError("streaming synthesis requires a causal unidirectional "
                             "bigcodec decoder config (a causal Conformer streams through "
                             "StreamingConformerSynthesizer)")
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
        self.delay_samples = self.delay_frames * self.hop

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
        """codes (Nq, B, n) int -> (wav (B, n · hop), new state).
        Anti-aliased, the samples are those of the span ``delay_frames``
        earlier; ``end``: the stream's true length in frames once known
        (``flush``)."""
        codes = torch.as_tensor(codes, device=self.device)
        with torch.no_grad(), full_fp32():
            return self._step(state, codes, end)

    def _step(self, state: SynthState, codes, end: int):
        dec = self.codec.decoder
        F_ = codes.shape[-1]
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
        nq = num_codebooks(self.cfg)
        zeros = torch.zeros(nq, B, self.chunk_frames, dtype=torch.long, device=self.device)
        outs, got = [], 0
        while got < self.delay_frames:
            wav, state = self.step(state, zeros, end)
            outs.append(wav)
            got += self.chunk_frames
        return torch.cat(outs, dim=1)[:, :self.delay_frames * self.hop], state


def _conformer_layer_step(p, x, kv, carry, *, n_head: int, pos_row: int, cos, sin, bias,
                          keep, conv_first: bool):
    """One causal Conformer layer over a chunk x (B, n, C) of frames whose
    first sits at cache row ``pos_row``. ``kv``: the layer's (k, v) caches
    (B, L, H, D), written in place at rows [pos_row, pos_row + n);
    attention reads rows [0, pos_row + n) under ``bias`` (``_cache_bias``).
    ``carry``: the (B, C, k - 1) ring of earlier GLU outputs. ``keep``: (B, n) False on
    warm-up frames, zeroed before the ring so that the depthwise conv reads
    the offline zero padding (None: all kept). ``conv_first``: the
    encoder's order (conv, ffn1, attn, ffn2), else the decoder's (attn,
    ffn1, conv, ffn2). Returns (x, new carry)."""
    B, n, C = x.shape
    hi = pos_row + n
    w, b = get_weight(p.conv.dw), p.conv.dw.b
    rings = []

    def depthwise(y):  # causal through the ring: no padding
        window = torch.cat([carry, y], dim=2)
        rings.append(window[:, :, -carry.shape[2]:])
        return conv1d(window, w, b, groups=C)

    def conv(x):
        return x + conv_module(rms_norm(x, p.conv_norm), p.conv, depthwise, keep)

    def attn(x):
        q, k, v = qkv_heads(rms_norm(x, p.attn_norm), p.attn, cos, sin, n_head)
        kv[0][:, pos_row:pos_row + n] = k
        kv[1][:, pos_row:pos_row + n] = v
        out = attend(q, kv[0][:, :hi], kv[1][:, :hi], bias)
        return x + linear(out.reshape(B, n, C), p.attn.out)

    x = conv(x) if conv_first else attn(x)
    x = x + feed_forward(rms_norm(x, p.ffn1_norm), p.ffn1)
    x = attn(x) if conv_first else conv(x)
    return x + feed_forward(rms_norm(x, p.ffn2_norm), p.ffn2), rings[0]


def _cache_bias(n: int, *, pos_row: int, min_row: int, device):
    """(n, pos_row + n) additive mask: query j (cache row pos_row + j) sees
    rows [min_row, pos_row + j]."""
    rows = torch.arange(pos_row + n, device=device)
    qrow = pos_row + torch.arange(n, device=device)
    return masked_bias((rows[None, :] >= min_row) & (rows[None, :] <= qrow[:, None]),
                       torch.float32)


def _refuse_concat_semantic(cfg):
    """A ``concat_semantic`` codec's tokens need the teacher's output per
    frame, which a live stream does not have (as in the JAX package)."""
    if cfg.train.use_semantic and cfg.train.concat_semantic:
        raise NotImplementedError("concat_semantic tokenization needs the teacher target "
                                  "per frame; no streaming path for it")


def _conformer_streaming_part(part, name: str, chunk_attr: str):
    if part.type != f"conformer_{name}" or not part.causal:
        raise ValueError(f"streaming the Conformer requires a causal conformer_{name} "
                         f"{chunk_attr} config")
    if part.ffn_type == "moe":
        raise NotImplementedError("streaming the Conformer covers dense-FFN configs; MoE "
                                  "capacity routing is batch/chunk-global (ops/moe.py)")
    if part.n_fft != part.window_size:
        raise NotImplementedError("streaming the Conformer assumes n_fft == window_size "
                                  "(every reference Conformer config)")


class KVCaches(list):
    """Per-layer (k, v) caches of one stream, each (B, L, H, D), written in
    place by every step; ``pos`` is the ``pos`` of the one state that may
    step them next."""

    def __init__(self, layers):
        super().__init__(layers)
        self.pos = 0

    def claim(self, pos: int, new_pos: int):
        """Hand the caches from the state at ``pos`` to the one at
        ``new_pos``; ``ValueError`` if that state was already stepped."""
        if pos != self.pos:
            raise ValueError(f"this stream state (at {pos}) was already stepped: its K/V "
                             f"caches hold the step to {self.pos}; a Conformer stream state "
                             "is single-use (step from the newest state, or init_state)")
        self.pos = new_pos


def _init_caches(part, batch_size: int, rows: int, device):
    H, D = part.n_head, part.dim // part.n_head
    zeros = lambda *s: torch.zeros(*s, device=device)  # noqa: E731
    return (KVCaches((zeros(batch_size, rows, H, D), zeros(batch_size, rows, H, D))
                     for _ in range(part.n_layers)),
            [zeros(batch_size, part.dim, part.conv_kernel_size - 1) for _ in range(part.n_layers)])


class ConformerStreamState(NamedTuple):
    sample_tail: torch.Tensor   # (B, tail) raw samples before the next chunk
    kv_cache: KVCaches          # per layer (k, v), each (B, L, H, D)
    conv_carry: Any             # per layer (B, dim, k - 1) GLU outputs
    pos: int = 0                # samples consumed so far


class StreamingConformerTokenizer:
    """Chunk-by-chunk tokenizer for a ``causal: true`` Conformer ``codec`` on
    ``device`` (the card unless ``device="cpu"``; raises without one). Each
    step emits the tokens of the chunk's frames ``delay_frames`` earlier
    (the stream's first ``delay_frames`` tokens are warm-up to discard);
    ``flush`` drains the last ``delay_frames`` with the stream's end, where
    the windows read the offline zero padding. A stream holds at most
    ``max_seq_len`` frames (the RoPE table); a step past them raises. A
    state is single-use (module docstring): step from the newest."""

    def __init__(self, codec: Codec, *, chunk_samples: int, device="cuda"):
        self.device = resolve_device(device)
        e = codec.cfg.model.codec_encoder
        _conformer_streaming_part(e, "stft", "encoder")
        _refuse_concat_semantic(codec.cfg)
        self.codec, self.cfg = codec, codec.cfg
        self.hop, self.win = e.hop_length, e.window_size
        if chunk_samples % self.hop != 0:
            raise ValueError(f"chunk_samples must be a multiple of hop {self.hop}")
        self.chunk = chunk_samples
        P = (self.win - self.hop) // 2
        self.delay_frames = max(0, -(-(self.win - P - self.hop) // self.hop))
        # the oldest emitted frame's window starts inside the kept samples
        self.tail = self.delay_frames * self.hop + P
        self.rows = e.max_seq_len + self.delay_frames  # cache row = frame + delay_frames

    def init_state(self, batch_size: int = 1) -> ConformerStreamState:
        kv, carry = _init_caches(self.cfg.model.codec_encoder, batch_size, self.rows,
                                 self.device)
        return ConformerStreamState(
            sample_tail=torch.zeros(batch_size, self.tail, device=self.device),
            kv_cache=kv, conv_carry=carry, pos=0)

    def step(self, state: ConformerStreamState, chunk):
        """chunk (B, S), S a multiple of hop -> (codes (Nq, B, S / hop), new
        state): the tokens of the frames ``delay_frames`` before the chunk's."""
        chunk = torch.as_tensor(chunk, dtype=torch.float32, device=self.device)
        max_frames = self.cfg.model.codec_encoder.max_seq_len
        if (state.pos + chunk.shape[1]) // self.hop > max_frames:
            raise ValueError(f"stream exceeds max_seq_len={max_frames} frames (the RoPE "
                             "table); restart with init_state or raise max_seq_len")
        with torch.no_grad(), full_fp32():
            return self._step(state, chunk)

    def _step(self, state: ConformerStreamState, chunk):
        enc = self.codec.encoder
        bb = enc.backbone
        B, S = chunk.shape
        n = S // self.hop
        buf = torch.cat([state.sample_tail, chunk], dim=1)
        # frame f0 + j's window starts at buf[j · hop]
        spec = stft(buf, n_fft=enc.n_fft, hop_length=self.hop, win_length=self.win,
                    center=False)[:, :, :n]
        h = encode_features(enc, spec)
        pos_row = state.pos // self.hop
        f0 = pos_row - self.delay_frames
        ar = torch.arange(n, device=self.device)
        keep = (ar >= -f0)[None, :].expand(B, n)
        cos, sin = bb.rope(self.device)
        fpos = (f0 + ar).clamp(0, bb.max_seq_len - 1)  # warm-up frames: any row
        cos, sin = cos[fpos], sin[fpos]
        bias = _cache_bias(n, pos_row=pos_row, min_row=self.delay_frames, device=self.device)
        state.kv_cache.claim(state.pos, state.pos + S)
        carry = []
        for layer, kv, c in zip(bb.layers, state.kv_cache, state.conv_carry):
            h, c = _conformer_layer_step(layer, h, kv, c, n_head=bb.n_head, pos_row=pos_row,
                                         cos=cos, sin=sin, bias=bias, keep=keep,
                                         conv_first=True)
            carry.append(c)
        _, codes, _ = quantize(self.codec, semantic_vq_in(self.codec, encode_output(enc, h)))
        return codes, ConformerStreamState(sample_tail=buf[:, -self.tail:],
                                           kv_cache=state.kv_cache, conv_carry=carry,
                                           pos=state.pos + S)

    def flush(self, state: ConformerStreamState):
        """Drain the last ``delay_frames`` tokens, the stream having ended:
        (codes (Nq, B, delay_frames), new state)."""
        B = state.sample_tail.shape[0]
        zeros = torch.zeros(B, self.delay_frames * self.hop, device=self.device)
        with torch.no_grad(), full_fp32():
            return self._step(state, zeros)


class ConformerSynthState(NamedTuple):
    kv_cache: KVCaches          # per layer (k, v), each (B, L, H, D)
    conv_carry: Any             # per layer (B, dim, k - 1)
    ola_tail: torch.Tensor      # (B, win - hop) overlap-add numerator carried
    env_tail: torch.Tensor      # (win - hop,) window envelope carried
    pos: int = 0                # frames decoded so far


class StreamingConformerSynthesizer:
    """Chunk-by-chunk decoder for a ``causal: true`` Conformer ``codec`` on
    ``device`` (the card unless ``device="cpu"``; raises without one),
    equal to offline ``decode`` to fp32 rounding. Frames map one to one to
    tokens; only the ISTFT looks ahead, P = (win - hop) / 2 samples, so a
    step emits the ``chunk_frames`` · hop samples that end
    ``delay_samples`` = P before its frames' end (the stream's first P
    samples are the region offline trims), and ``flush`` drains the last
    P with the stream's final envelope. Any step may take another frame
    count. Feed it tokens without the tokenizer's warm-up: it is causal,
    and warm-up frames would reach every later frame. A state is
    single-use (module docstring): step from the newest."""

    def __init__(self, codec: Codec, *, chunk_frames: int, device="cuda"):
        self.device = resolve_device(device)
        d = codec.cfg.model.codec_decoder
        _conformer_streaming_part(d, "istft", "decoder")
        self.codec, self.cfg = codec, codec.cfg
        self.hop, self.win = d.hop_length, d.window_size
        self.chunk_frames = chunk_frames
        self.delay_samples = (self.win - self.hop) // 2
        self.rows = d.max_seq_len

    def init_state(self, batch_size: int = 1) -> ConformerSynthState:
        kv, carry = _init_caches(self.cfg.model.codec_decoder, batch_size, self.rows,
                                 self.device)
        return ConformerSynthState(
            kv_cache=kv, conv_carry=carry,
            ola_tail=torch.zeros(batch_size, self.win - self.hop, device=self.device),
            env_tail=torch.zeros(self.win - self.hop, device=self.device), pos=0)

    def step(self, state: ConformerSynthState, codes):
        """codes (Nq, B, n) -> (wav (B, n · hop), new state): the samples
        ``delay_samples`` before the end of these frames."""
        codes = torch.as_tensor(codes, device=self.device)
        if state.pos + codes.shape[-1] > self.rows:
            raise ValueError(f"stream exceeds max_seq_len={self.rows} frames (the RoPE "
                             "table); restart with init_state or raise max_seq_len")
        with torch.no_grad(), full_fp32():
            return self._step(state, codes)

    def _step(self, state: ConformerSynthState, codes):
        dec = self.codec.decoder
        bb = dec.backbone
        n = codes.shape[-1]
        hop, win = self.hop, self.win
        h = apply_fc_post_a(self.codec, codes_to_emb(self.codec, codes.permute(1, 2, 0)))
        h = h.transpose(1, 2)
        if hasattr(dec, "input_proj"):
            h = pointwise(h, dec.input_proj)
        f0 = state.pos
        cos, sin = (t[f0:f0 + n] for t in bb.rope(self.device))
        bias = _cache_bias(n, pos_row=f0, min_row=0, device=self.device)
        state.kv_cache.claim(f0, f0 + n)
        carry = []
        for layer, kv, c in zip(bb.layers, state.kv_cache, state.conv_carry):
            h, c = _conformer_layer_step(layer, h, kv, c, n_head=bb.n_head, pos_row=f0,
                                         cos=cos, sin=sin, bias=bias,
                                         keep=None, conv_first=False)
            carry.append(c)
        spec = head_spectrum(dec, rms_norm(h, dec.norm))  # (B, n, F)
        window = hann_window(win, device=self.device)
        frames = torch.fft.irfft(spec, n=win, dim=2) * window
        buf = overlap_add(frames, hop)  # (B, n · hop + win - hop)
        buf[:, :win - hop] += state.ola_tail
        env = overlap_add((window * window).expand(1, n, -1), hop)[0]
        env[:win - hop] += state.env_tail
        # samples [0, n · hop) have every frame they take
        wav = buf[:, :n * hop] / env[:n * hop].clamp_min(torch.finfo(torch.float32).tiny)
        return wav, ConformerSynthState(kv_cache=state.kv_cache, conv_carry=carry,
                                        ola_tail=buf[:, n * hop:], env_tail=env[n * hop:],
                                        pos=state.pos + n)

    def flush(self, state: ConformerSynthState):
        """Drain the ``delay_samples`` still in the latency window, the code
        stream having ended: its envelope is now the offline end-of-signal
        one. (wav (B, delay_samples), state)."""
        tiny = torch.finfo(torch.float32).tiny
        P = self.delay_samples
        return state.ola_tail[:, :P] / state.env_tail[None, :P].clamp_min(tiny), state


def stream_decode(codec: Codec, codes, *, chunk_frames: int, device="cuda"):
    """A whole code stream (Nq, B, T_frames) decoded chunk by chunk through
    the streaming synthesizer of the codec's family -> (B, T_frames · hop)
    on ``device``, equal to offline ``decode`` to fp32 rounding. It
    discards the leading latency samples and drains the tail with
    ``flush``; a trailing partial chunk is one shorter step. What
    ``cli/synthesize.py --streaming`` runs, and the template of a live loop
    (feed chunks as they arrive)."""
    syn = SYNTHESIZERS[codec.cfg.model.codec_decoder.type](codec, chunk_frames=chunk_frames,
                                                          device=device)
    codes = torch.as_tensor(codes, device=syn.device)
    T, B = codes.shape[-1], codes.shape[1]
    state = syn.init_state(batch_size=B)
    pieces = []
    for t in range(0, T, chunk_frames):
        wav, state = syn.step(state, codes[:, :, t:t + chunk_frames])
        pieces.append(wav)
    tail, _ = syn.flush(state)
    pieces.append(tail)
    skip = syn.delay_samples
    return torch.cat(pieces, dim=1)[:, skip:skip + T * syn.hop]


# the streaming synthesizer of each decoder ``type``
SYNTHESIZERS = {"bigcodec": StreamingSynthesizer,
                "conformer_istft": StreamingConformerSynthesizer}
