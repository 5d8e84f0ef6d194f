"""Sequence parallelism: one long utterance sharded over devices by time
(counterpart of ``audiotokenization_tpu/parallel/sp.py``).

Tokenize (``make_sp_tokenizer``): the waveform is zero-padded to n chunks
of a bucketed length, and shard d's window is its chunk with ``ctx``
samples of real neighbour audio on each side (the encoder's receptive
field, ``utils/chunked.py::receptive_field_samples``); zeros past the
ends, as the whole sequence's convs see. Two LSTM policies:

- ``lstm="exact"`` (BigCodec only): each shard runs the conv front on its
  window with ``_edge_mask`` after every conv and unit, so each layer's
  values outside the true sequence are zero as the whole sequence's
  per-layer zero padding makes them; the one-way ResLSTM is chained shard
  to shard (shard d's scan starts from shard d-1's final (h, c), copied to
  its device: the same sequence of per-frame operations as the whole
  scan); the tail (snake_out, conv_out k3) reads its neighbours' frames.
  Tokens equal one-device ``tokenize``. JAX's n-phase SPMD relay computes
  the LSTM n times over; one process chains the shards instead.
- ``lstm="reset"``: each shard runs ``tokenize`` on its window, the LSTM
  starting from zero and warming up over the context (``utils/chunked.py``
  as one parallel call); any encoder.

Each shard quantizes its own frames: one K1 launch a shard, and on the
flagship 15 K2 launches a shard (a non-causal, non-anti-aliased unit is
one K2 call, ``models/bigcodec.py::ResidualUnit.fused``). K2 takes only
contiguous tensors: every slice that reaches a unit is made contiguous.

Synthesize (``make_sp_synthesizer``, the BigCodec decoder): one code
stream sharded by frames; each shard decodes its chunk (conv_in, the
LSTM chained, each DecoderBlock's transpose conv run VALID over a halo
window and cut to the chunk's margin, the three units consuming the
margin, the tail) and the waveform equals one-device ``decode`` to fp32
rounding.

Positions are Python ints here (JAX traces them). The devices come from
``parallel/mesh.py::data_devices``; a device may repeat, and a codec has
one copy per distinct device (``mesh.Replicas``). The exchanges are
tensor copies between devices.

``_AA_REACH``, ``_replicate_window`` and ``_SPAA`` carry Activation1d's
true-edge replicate padding into a window of a longer sequence; the
streaming runtime (``models/streaming.py``) uses them too.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ..config import Config, codec_hop
from ..models import bigcodec
from ..models.codec import (allow_tf32, apply_fc_post_a, bf16_copies, codes_to_emb,
                            full_fp32, quantize, semantic_vq_in, tokenize)
from ..ops.alias_free import downsample1d, resample_filter, upsample1d
from ..ops.conv import conv1d, conv_transpose1d
from ..ops.lstm import res_lstm_streaming
from ..ops.params import parameters_as
from ..ops.snake import snake_beta
from ..utils.chunked import receptive_field_samples
from .mesh import Replicas, data_devices

# the one-sided reach, in positions at its scale, of one Activation1d
# resample pair: the 2x upsample's taps reach +-3 input positions (K = 12
# windowed sinc, stride 2), the 2x downsample's another +-3, plus 2 margin
_AA_REACH = 8

SP_MODES = ("conformant", "high", "fast")


def _replicate_window(x, g0: int, bound: int):
    """x (B, C, L) holding the global positions g0 + j: positions before 0
    take the value at global 0 and positions >= bound the value at
    bound - 1, wherever the window holds them (a window wholly outside
    [0, bound) gives values its caller discards)."""
    L = x.shape[-1]
    lo = min(max(-g0, 0), L - 1)
    hi = min(max(max(bound, 1) - 1 - g0, 0), L - 1)
    return F.pad(x[..., lo:hi + 1], (lo, L - 1 - hi), mode="replicate")


def _zero_outside(x, g0: int, bound: int):
    """x with its global positions outside [0, bound) set to 0."""
    L = x.shape[-1]
    a = min(max(-g0, 0), L)
    b = min(max(bound - g0, a), L)
    return F.pad(x[..., a:b], (a, L - b))


class _SPAA:
    """Activation1d with the true edges of the sequence inside a window
    starting at global position g0: replicate the input at the true edges,
    2x upsample, snake, replicate the upsampled signal at the (2x) true
    edges, 2x downsample, then zero the positions outside [0, bound) so the
    following convs see the whole sequence's zero padding. The filters'
    error at the window's own edges stays within ``_AA_REACH`` positions,
    which callers provide. Without anti-aliasing a plain snake."""

    def __init__(self, antialias: bool, g0: int, bound: int):
        self._aa = bigcodec._AA(antialias)
        self.antialias = antialias
        self.g0, self.bound = g0, bound

    def __call__(self, x, snake):
        if not self.antialias:
            return self._aa(x, snake)
        filt = resample_filter(2, x.device, x.dtype)
        x = upsample1d(_replicate_window(x, self.g0, self.bound), filt, 2)
        x = snake_beta(x, snake.alpha, snake.beta)
        x = _replicate_window(x, 2 * self.g0, 2 * self.bound)
        return _zero_outside(downsample1d(x, filt, 2), self.g0, self.bound)


def _edge_mask(x, start: int, S: int, T: int):
    """x (B, C, L) with its positions whose global index at stride scale S
    (``start // S + j``) falls outside [0, T // S) set to 0: the whole
    sequence's convs zero-pad their own input at every layer, where a
    window lets earlier layers bleed real audio past the true edges. A
    window wholly inside comes back as it is."""
    g0, bound, L = start // S, T // S, x.shape[-1]
    if g0 >= 0 and g0 + L <= bound:
        return x
    g = g0 + torch.arange(L, device=x.device)
    return x * ((g >= 0) & (g < bound)).to(x.dtype)


def _halo_extend(xs, h_left: int, h_right: int):
    """Each shard's x (..., L) with its left neighbour's last ``h_left``
    and its right neighbour's first ``h_right`` positions on either side,
    copied to its device; zeros at the ends, the whole sequence's padding."""
    out = []
    for d, x in enumerate(xs):
        parts = []
        if h_left:
            parts.append(xs[d - 1][..., -h_left:].to(x.device) if d > 0
                         else x.new_zeros(*x.shape[:-1], h_left))
        parts.append(x)
        if h_right:
            parts.append(xs[d + 1][..., :h_right].to(x.device) if d + 1 < len(xs)
                         else x.new_zeros(*x.shape[:-1], h_right))
        out.append(torch.cat(parts, dim=-1))
    return out


def _lstm_relay(lstms, lats):
    """The one-way ResLSTM over the shards' frames (B, F, L) in order:
    shard d's scan starts from shard d-1's final (h, c), copied to its
    device."""
    state, out = None, []
    for lstm, lat in zip(lstms, lats):
        if state is not None:
            state = [(h.to(lat.device), c.to(lat.device)) for h, c in state]
        y, state = res_lstm_streaming(lat, lstm, state)
        out.append(y)
    return out


def _conv_front(enc, x, start: int, T: int, aa_factory=None):
    """The BigCodec encoder's conv_in and blocks on a window x (B, 1, Tw)
    whose first sample is global sample ``start`` of a sequence of T
    samples, with ``_edge_mask`` after every conv and unit -> (B, C,
    Tw / hop). ``aa_factory(S)``: the Activation1d at stride scale S
    (default the plain one, exact only without anti-aliasing)."""
    aa_factory = aa_factory or (lambda S: bigcodec._AA(enc.antialias))
    x = _edge_mask(bigcodec._wn_conv(x, enc.conv_in, padding=3, causal=enc.causal), start, 1, T)
    S = 1
    for block, stride in zip(enc.blocks, enc.up_ratios):
        aa = aa_factory(S)
        for unit, d in zip(block.units, enc.dilations):
            x = _edge_mask(bigcodec.residual_unit(x, unit, dilation=d, aa=aa), start, S, T)
        x = aa(x, block.snake)
        if stride != 1:
            x = bigcodec._wn_conv(x, block.down, stride=stride,
                                  padding=stride // 2 + stride % 2, causal=enc.causal)
        else:
            x = bigcodec._wn_conv(x, block.down)
        S *= stride
        x = _edge_mask(x, start, S, T)
    return x


def _tail(encs, lats, *, ckf: int, tmf: int):
    """snake_out -> conv_out k3 over each shard's exact frames (B, C, ckf),
    reading its neighbours' frames: conv_out reaches one frame across (two
    to the left, causal), and anti-aliasing puts an Activation1d of
    ``_AA_REACH`` frames in front, through ``_SPAA``. tmf: the sequence's
    frames."""
    enc0 = encs[0]
    lpad, rpad = (2, 0) if enc0.causal else (1, 1)
    m = _AA_REACH if enc0.antialias else 0
    hl, hr = lpad + m, rpad + m
    out = []
    for d, (enc, xx) in enumerate(zip(encs, _halo_extend(lats, hl, hr))):
        if enc.antialias:
            xx = _SPAA(True, d * ckf - hl, tmf)(xx, enc.snake_out)
            xx = xx[..., m:m + lpad + ckf + rpad]
        else:
            xx = bigcodec._AA(False)(xx, enc.snake_out)
        out.append(conv1d(xx, enc.conv_out.weight(), enc.conv_out.b))
    return out


def _precision(encs, mode: str):
    """The context of a tokenize mode over the distinct encoders: fp32 with
    TF32 off (conformant), TF32 (high), or bf16 copies of the parameters
    with TF32 off (fast; K2 stays the fp32-grade kernel, a bf16 cast around
    it)."""
    stack = contextlib.ExitStack()
    stack.enter_context(allow_tf32() if mode == "high" else full_fp32())
    if mode == "fast":
        for enc in {id(e): e for e in encs}.values():
            stack.enter_context(parameters_as(enc, bf16_copies(enc)))
    return stack


def make_sp_tokenizer(cfg: Config, devices=None, *, mode: str = "conformant",
                      lstm: str = "exact", context_seconds: float | None = None,
                      chunk_quantum_seconds: float = 1.0, device="cuda"):
    """``tokenize(codec, wav)``: one waveform (T,) -> codes (Nq, T // hop)
    on the first device, sharded over ``devices`` (``mesh.data_devices``:
    every visible card by default, ``[cpu]`` for ``device="cpu"``).

    mode: conformant, high or fast (``balanced`` has no sequence-parallel
    form); lstm: exact or reset (module docstring). Each shard's chunk is a
    multiple of ``chunk_quantum_seconds`` and at least the context; the
    waveform's zero padding up to n chunks cannot reach a kept frame (the
    edge mask reproduces the whole sequence's padding, and the LSTM runs
    left to right). ``tokenize.buckets``: the chunk lengths seen.
    """
    e = cfg.model.codec_encoder
    if mode not in SP_MODES:
        raise ValueError(f"unknown sp tokenize mode {mode!r} "
                         "(supported: conformant | high | fast)")
    if lstm not in ("exact", "reset"):
        raise ValueError(f"unknown sp lstm policy {lstm!r} (supported: exact | reset)")
    if lstm == "exact" and e.type != "bigcodec":
        raise NotImplementedError("lstm='exact' requires the bigcodec encoder")
    if lstm == "exact" and e.use_rnn and e.rnn_bidirectional:
        raise NotImplementedError(
            "exact sequence-parallel LSTM relay is unidirectional; use "
            "lstm='reset' for bidirectional encoder RNNs")
    devices = data_devices(devices, device=device)
    n = len(devices)
    hop = codec_hop(cfg)
    sr = cfg.dataset.sample_rate
    if context_seconds is None:
        ctx = -(-receptive_field_samples(cfg) // hop) * hop
    else:
        ctx = int(context_seconds * sr) // hop * hop
    quantum = max(int(chunk_quantum_seconds * sr) // hop * hop, hop)
    cf = ctx // hop
    replicas = Replicas()
    buckets: set = set()

    def exact_latents(codecs, windows, chunk: int, tm: int):
        encs = [c.encoder for c in codecs]
        ckf = chunk // hop
        dtype = torch.bfloat16 if mode == "fast" else torch.float32
        with _precision(encs, mode):
            lats = []
            for d, (enc, w) in enumerate(zip(encs, windows)):
                start = d * chunk - ctx
                lat = _conv_front(enc, w[None, None].to(dtype), start, tm,
                                  aa_factory=lambda S, s=start: _SPAA(enc.antialias, s // S,
                                                                      tm // S))
                lats.append(lat[:, :, cf:cf + ckf])
            if e.use_rnn:
                lats = _lstm_relay([enc.lstm for enc in encs], lats)
            # the pad frames past the sequence would reach its last frame
            # through conv_out; the whole sequence pads them with zeros
            lats = [_edge_mask(lat, d * ckf, 1, tm // hop) for d, lat in enumerate(lats)]
            return [lat.float() for lat in _tail(encs, lats, ckf=ckf, tmf=tm // hop)]

    def sp_tokenize(codec, wav):
        wav = torch.as_tensor(wav, dtype=torch.float32).reshape(-1)
        T = wav.shape[0]
        # the halos are neighbour-only: each chunk covers the context
        chunk = max(-(-T // (n * quantum)) * quantum, -(-ctx // quantum) * quantum)
        buckets.add(chunk)
        padded = F.pad(wav, (ctx, ctx + n * chunk - T))
        windows = [padded[d * chunk:d * chunk + chunk + 2 * ctx].to(dev).contiguous()
                   for d, dev in enumerate(devices)]
        codecs = [replicas(codec, dev) for dev in devices]
        tm = -(-T // hop) * hop
        if lstm == "reset":
            codes = [tokenize(c, w[None], mode=mode)[:, :, cf:cf + chunk // hop]
                     for c, w in zip(codecs, windows)]
        else:
            with torch.no_grad():
                lats = exact_latents(codecs, windows, chunk, tm)
                codes = []
                with full_fp32():
                    for c, lat in zip(codecs, lats):
                        codes.append(quantize(c, semantic_vq_in(c, lat))[1])
        out = torch.cat([q.to(devices[0]) for q in codes], dim=-1)
        return out[:, 0, :T // hop]

    sp_tokenize.buckets = buckets
    return sp_tokenize


def tokenize_sequence_parallel(codec, wav, devices=None, *, mode: str = "conformant",
                               lstm: str = "exact", context_seconds: float | None = None,
                               device="cuda"):
    """One call of ``make_sp_tokenizer`` with chunks to the hop (no
    bucketing); for a corpus, build the tokenizer once."""
    tok = make_sp_tokenizer(codec.cfg, devices, mode=mode, lstm=lstm,
                            context_seconds=context_seconds,
                            chunk_quantum_seconds=1.0 / codec.cfg.dataset.sample_rate,
                            device=device)
    return tok(codec, wav)


def _sp_block_margins(stride: int, dilations, antialias: bool):
    """(M, h): the residual units' margin at a DecoderBlock's output scale,
    and the input-scale halo that covers it, the transpose conv's padding
    and (anti-aliased) the block Activation1d's reach."""
    m_aa = _AA_REACH if antialias else 0
    pad_ref = stride // 2 + stride % 2 if stride != 1 else 0
    # a unit: Activation1d (+-m_aa) -> k7 conv dilation d (+-3d) ->
    # Activation1d (+-m_aa) -> k1 conv
    M = sum(3 * d + 2 * m_aa for d in dilations)
    h = -(-(M + pad_ref) // max(stride, 1)) + 1 + m_aa
    return M, h


def _decoder_block_sp(blocks, xs, *, stride: int, dilations, antialias: bool, L: int,
                      S_out: int, tm: int):
    """One DecoderBlock (snake -> transpose conv -> 3 units) over the
    shards' exact chunks (1, C, L) at the block's input scale -> their
    exact chunks (1, C', L · stride). Each window is halo-extended first
    (the block's Activation1d through ``_SPAA``; a plain snake is pointwise),
    the transpose conv runs VALID and is cut so that out[q] is the whole
    sequence's out[d·L·stride - M + q], and the units consume the margin M
    with ``_edge_mask`` after each. ``blocks``: each shard's DecoderBlock;
    S_out: samples a frame at the output scale; tm: the sequence's frames."""
    M, h = _sp_block_margins(stride, dilations, antialias)
    pad_ref = stride // 2 + stride % 2 if stride != 1 else 0
    if L < h:
        raise ValueError(f"per-device chunk {L} frames < halo {h}; use a "
                         f"longer input or fewer devices")
    out = []
    for d, (p, x) in enumerate(zip(blocks, _halo_extend(xs, h, h))):
        x = _SPAA(antialias, d * L - h, tm * (S_out // stride))(x, p.snake)
        y = conv_transpose1d(x, p.up.weight(), p.up.b, stride=stride)
        # local -> global: y[q] is the whole sequence's (d·L - h)·stride - pad_ref + q
        q0 = h * stride + pad_ref - M
        assert q0 >= 0 and q0 + L * stride + 2 * M <= y.shape[-1], (q0, y.shape)
        start = d * L * stride - M
        y = _edge_mask(y[..., q0:q0 + L * stride + 2 * M].contiguous(), start, 1, tm * S_out)
        aa = _SPAA(antialias, start, tm * S_out)
        for unit, dil in zip(p.units, dilations):
            y = _edge_mask(bigcodec.residual_unit(y, unit, dilation=dil, aa=aa),
                           start, 1, tm * S_out)
        out.append(y[..., M:M + L * stride])
    return out


def make_sp_synthesizer(cfg: Config, devices=None, *, chunk_quantum_frames: int = 80,
                        device="cuda"):
    """``synthesize(codec, codes)``: one code stream (Nq, Tf) or (Tf,) ->
    waveform (Tf · hop,) on the first device, sharded by frames over
    ``devices`` (as in ``make_sp_tokenizer``), equal to one-device
    ``decode`` of the codes to fp32 rounding (fp32, TF32 off). The
    non-causal BigCodec decoder with a one-way RNN and no stride-1 block;
    each shard's chunk is a multiple of ``chunk_quantum_frames`` and at
    least the first block's halo. ``synthesize.buckets``: the chunk
    lengths seen."""
    d = cfg.model.codec_decoder
    if d.type != "bigcodec":
        raise NotImplementedError("sequence-parallel synthesis requires the "
                                  "bigcodec decoder")
    if d.causal or d.rnn_bidirectional:
        raise NotImplementedError("sp synthesis covers the non-causal, "
                                  "unidirectional-RNN decoder configs")
    if any(s == 1 for s in d.up_ratios):
        # a stride-1 transpose conv runs with padding 0 (the length grows by
        # K - 1), which the halo / q0 mapping does not model
        raise NotImplementedError("sp synthesis does not support stride-1 "
                                  "decoder up_ratios")
    devices = data_devices(devices, device=device)
    n = len(devices)
    up_ratios, dilations = tuple(d.up_ratios), tuple(d.dilations)
    hop = 1
    for s in up_ratios:
        hop *= s
    _, h_first = _sp_block_margins(up_ratios[0], dilations, d.antialias)
    m = _AA_REACH if d.antialias else 0
    min_chunk = max(h_first, 3 + m)
    replicas = Replicas()
    buckets: set = set()

    def synthesize(codec, codes):
        codes = torch.as_tensor(codes)
        if codes.ndim == 1:
            codes = codes[None]
        tf = codes.shape[-1]
        q = max(chunk_quantum_frames, 1)
        L = max(-(-tf // (n * q)) * q, -(-min_chunk // q) * q)
        buckets.add(L)
        padded = F.pad(codes, (0, n * L - tf))
        codecs = [replicas(codec, dev) for dev in devices]
        decs = [c.decoder for c in codecs]
        with torch.no_grad(), full_fp32():
            xs = []
            for i, (c, dev) in enumerate(zip(codecs, devices)):
                chunk = padded[:, i * L:(i + 1) * L].to(dev)
                # a semantic codec decodes fc_post_a(zq): per frame, so before the mask
                z = apply_fc_post_a(c, codes_to_emb(c, chunk.t()[None]))
                xs.append(_edge_mask(z, i * L, 1, tf))  # the pad code's embedding is not 0
            xs = [_edge_mask(conv1d(x, dec.conv_in.weight(), dec.conv_in.b), i * L, 1, tf)
                  for i, (dec, x) in enumerate(zip(decs, _halo_extend(xs, 3, 3)))]
            if d.use_rnn:
                xs = [_edge_mask(x, i * L, 1, tf)
                      for i, x in enumerate(_lstm_relay([dec.lstm for dec in decs], xs))]
            Lc, S_out = L, 1
            for b, stride in enumerate(up_ratios):
                xs = _decoder_block_sp([dec.blocks[b] for dec in decs], xs, stride=stride,
                                       dilations=dilations, antialias=d.antialias, L=Lc,
                                       S_out=S_out * stride, tm=tf)
                Lc, S_out = Lc * stride, S_out * stride
            # snake_out (an Activation1d of +-_AA_REACH when anti-aliased) and
            # conv_out k7 over the neighbours' samples
            outs = []
            for i, (dec, x) in enumerate(zip(decs, _halo_extend(xs, 3 + m, 3 + m))):
                x = _SPAA(d.antialias, i * Lc - (3 + m), tf * hop)(x, dec.snake_out)
                if m:
                    x = x[..., m:m + Lc + 6]
                outs.append(torch.tanh(conv1d(x, dec.conv_out.weight(), dec.conv_out.b)))
        wav = torch.cat([o.to(devices[0]) for o in outs], dim=-1)
        return wav[0, 0, :tf * hop]

    synthesize.buckets = buckets
    return synthesize
