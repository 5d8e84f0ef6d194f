"""BigCodec convolutional encoder / decoder.

Counterpart of ``audiotokenization_tpu/models/bigcodec.py``: the
non-causal codec, the causal one (the reference's streaming convs: left
padding only, transpose convs trimmed on the right) and the anti-aliased
one (each snake inside an Activation1d, ``ops/alias_free.py``), alone or
together.

Encoder: WNConv1d(1 -> ngf, k7) -> 5x EncoderBlock (channels double per
stride of up_ratios = (2, 2, 2, 5, 5)) -> ResLSTM -> SnakeBeta ->
WNConv1d(-> out_channels, k3). Decoder: WNConv1d(-> 1536, k7) -> ResLSTM ->
5x DecoderBlock (transpose conv halving channels) -> SnakeBeta ->
WNConv1d(-> 1, k7) -> tanh. Each block holds 3 ResidualUnits (dilations
1/3/9).

Route of a ResidualUnit, fixed by the config when the module is built
(``ResidualUnit.fused``): a non-causal unit without anti-aliasing is one
call of kernel K2 (``fused_residual_unit``: the kernel on CUDA tensors, its
plain version on CPU tensors), the domain of the JAX package's Pallas K2;
a causal or anti-aliased unit runs on stock PyTorch ops (cuDNN on the
card), as the JAX package runs it on XLA.

The encoder and decoder functions take an optional ``aa``: an
Activation1d with the config's ``antialias`` that the ragged and streaming
paths replace with one that knows the true edges of each sequence
(``MaskedAA`` below, ``parallel/sp.py::_SPAA``).

Ragged batches (``lengths``): files of unequal length go in as one
zero-padded batch with their lengths. A longer zero tail would move where
each conv layer's zero padding begins, so ``edge_mask`` zeroes each
sample's positions past its own length after every conv, ResidualUnit and
transpose conv, and the ResLSTM takes a per-sample prefix mask
(``ops/lstm.py``). Anti-aliased configs need more: each Activation1d
replicate-pads at the file's own edge, so ``MaskedAA`` replicates each
sample's tail from its last valid position before the 2x upsample and
again before the 2x downsample, then re-zeroes it. Each sample then
computes what it computes alone (``utils/ragged.py``).

Init: the reference's weight-normed convs effectively start from torch's
default (kaiming-uniform v, g = ‖v‖) with zeroed biases; transpose convs
keep torch's default bias.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.alias_free import activation1d, downsample1d, resample_filter, upsample1d
from ..ops.conv import (causal_conv1d, causal_conv_transpose1d, conv1d, conv_transpose1d,
                        init_wn_conv1d, init_wn_conv_transpose1d)
from ..ops.cuda.residual_unit_kernel import fused_residual_unit
from ..ops.lstm import init_lstm, res_lstm
from ..ops.params import checkpointed
from ..ops.snake import SnakeBeta, snake_beta
from ..parallel.fsdp import run_block


def _wn_conv(x, p, *, stride=1, padding=0, dilation=1, causal=False):
    if causal:
        return causal_conv1d(x, p.weight(), p.b, stride=stride, dilation=dilation)
    return conv1d(x, p.weight(), p.b, stride=stride, padding=padding,
                  dilation=dilation)


def _wn_tconv(x, p, *, stride=1, padding=0, output_padding=0, causal=False):
    if causal:
        return causal_conv_transpose1d(x, p.weight(), p.b, stride=stride)
    return conv_transpose1d(x, p.weight(), p.b, stride=stride, padding=padding,
                            output_padding=output_padding)


class _AA:
    """Activation1d around a ``SnakeBeta`` module's snake: plain, or with
    ``antialias`` between the 2x resampling filters."""

    def __init__(self, antialias: bool):
        self.antialias = antialias

    def __call__(self, x, snake: SnakeBeta):
        return activation1d(x, lambda y: snake_beta(y, snake.alpha, snake.beta),
                            antialias=self.antialias)


class ResidualUnit(nn.Module):
    def __init__(self, dim: int, *, causal: bool = False, antialias: bool = False,
                 generator: torch.Generator):
        super().__init__()
        self.causal, self.antialias = causal, antialias
        self.fused = not (causal or antialias)  # K2's domain
        self.snake1 = SnakeBeta(dim)
        self.conv1 = init_wn_conv1d(dim, dim, 7, generator=generator)
        self.snake2 = SnakeBeta(dim)
        self.conv2 = init_wn_conv1d(dim, dim, 1, generator=generator)


def residual_unit(x, p: ResidualUnit, *, dilation: int, aa: _AA | None = None):
    """x + [Snake, WNConv k7 dil, Snake, WNConv k1](x): one K2 call for a
    fused unit (``aa`` is then a plain snake and unused), else stock ops
    with ``aa`` (default ``_AA(p.antialias)``) around each snake."""
    if p.fused:
        return fused_residual_unit(
            x, p.conv1.weight(), p.conv1.b, p.conv2.weight(), p.conv2.b,
            p.snake1.alpha, p.snake1.beta, p.snake2.alpha, p.snake2.beta,
            dilation=dilation)
    aa = aa if aa is not None else _AA(p.antialias)
    y = _wn_conv(aa(x, p.snake1), p.conv1, padding=3 * dilation, dilation=dilation,
                 causal=p.causal)
    return x + _wn_conv(aa(y, p.snake2), p.conv2)


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, stride: int, n_units: int, *, causal: bool = False,
                 antialias: bool = False, generator: torch.Generator):
        super().__init__()
        self.causal = causal
        self.units = nn.ModuleList(
            ResidualUnit(dim // 2, causal=causal, antialias=antialias, generator=generator)
            for _ in range(n_units))
        self.snake = SnakeBeta(dim // 2)
        self.down = init_wn_conv1d(dim // 2, dim, 2 * stride if stride != 1 else 1,
                                   generator=generator)


def encoder_block(x, p: EncoderBlock, *, stride: int, dilations, aa: _AA):
    """3 ResidualUnits -> Snake -> strided down conv."""
    for unit, d in zip(p.units, dilations):
        x = residual_unit(x, unit, dilation=d, aa=aa)
    x = aa(x, p.snake)
    if stride != 1:
        return _wn_conv(x, p.down, stride=stride, padding=stride // 2 + stride % 2,
                        causal=p.causal)
    return _wn_conv(x, p.down)


class DecoderBlock(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, stride: int, n_units: int, *,
                 causal: bool = False, antialias: bool = False, generator: torch.Generator):
        super().__init__()
        self.causal = causal
        self.snake = SnakeBeta(in_dim)
        self.up = init_wn_conv_transpose1d(in_dim, out_dim,
                                           2 * stride if stride != 1 else 1,
                                           generator=generator)
        self.units = nn.ModuleList(
            ResidualUnit(out_dim, causal=causal, antialias=antialias, generator=generator)
            for _ in range(n_units))


def decoder_block(x, p: DecoderBlock, *, stride: int, dilations, aa: _AA):
    """Snake -> transpose conv -> 3 ResidualUnits."""
    x = aa(x, p.snake)
    if stride != 1:
        x = _wn_tconv(x, p.up, stride=stride, padding=stride // 2 + stride % 2,
                      output_padding=stride % 2, causal=p.causal)
    else:
        x = _wn_tconv(x, p.up)
    for unit, d in zip(p.units, dilations):
        x = residual_unit(x, unit, dilation=d, aa=aa)
    return x


class BigCodecEncoder(nn.Module):
    """wav (B, 1, T) -> latents (B, out_channels, T / prod(up_ratios))."""

    modes = ("conformant", "high", "balanced", "fast")  # balanced: bf16 front, fp32 tail

    @classmethod
    def from_config(cls, e, *, generator: torch.Generator):
        """From the ``codec_encoder`` group ``e`` of a config."""
        return cls(ngf=e.ngf, up_ratios=e.up_ratios, dilations=e.dilations,
                   out_channels=e.out_channels, use_rnn=e.use_rnn,
                   rnn_num_layers=e.rnn_num_layers, rnn_bidirectional=e.rnn_bidirectional,
                   causal=e.causal, antialias=e.antialias, generator=generator)

    def __init__(self, *, ngf=48, up_ratios=(2, 2, 2, 5, 5), dilations=(1, 3, 9),
                 out_channels=1024, use_rnn=True, rnn_num_layers=2,
                 rnn_bidirectional=False, causal=False, antialias=False,
                 generator: torch.Generator):
        super().__init__()
        self.up_ratios, self.dilations = tuple(up_ratios), tuple(dilations)
        self.causal, self.antialias = causal, antialias
        self.conv_in = init_wn_conv1d(1, ngf, 7, generator=generator)
        d = ngf
        blocks = []
        for stride in self.up_ratios:
            d *= 2
            blocks.append(EncoderBlock(d, stride, len(self.dilations), causal=causal,
                                       antialias=antialias, generator=generator))
        self.blocks = nn.ModuleList(blocks)
        self.lstm = None
        if use_rnn:
            hid = d if not rnn_bidirectional else d // 2
            self.lstm = init_lstm(d, hid, num_layers=rnn_num_layers,
                                  bidirectional=rnn_bidirectional, generator=generator)
        self.snake_out = SnakeBeta(d)
        self.conv_out = init_wn_conv1d(d, out_channels, 3, generator=generator)

    def stages(self, lengths=None, *, remat: bool = False):
        """(front, tail) of ``forward``: conv_in and the blocks, then the
        ResLSTM, snake_out and conv_out (the ``balanced`` mode's split).
        ``lengths``: (B,) samples of a zero-padded ragged batch."""
        if lengths is None:
            return (lambda x: encode_front(self, x, remat=remat),
                    lambda y: encode_tail(self, y))
        return (lambda x: masked_front(self, x, lengths),
                lambda y: masked_tail(self, y, lengths))

    def forward(self, x, *, lengths=None, remat: bool = False):
        """``remat``: each EncoderBlock's activations are recomputed in the
        backward; ``lengths``: (B,) samples of a ragged batch (frames past
        lengths // hop are meaningless)."""
        front, tail = self.stages(lengths, remat=remat)
        return tail(front(x))


class BigCodecDecoder(nn.Module):
    """quantized latents (B, in_channels, Tf) -> waveform (B, 1, Tf · hop)."""

    @classmethod
    def from_config(cls, d, *, generator: torch.Generator):
        """From the ``codec_decoder`` group ``d`` of a config."""
        return cls(in_channels=d.in_channels,
                   upsample_initial_channel=d.upsample_initial_channel,
                   up_ratios=d.up_ratios, dilations=d.dilations, use_rnn=d.use_rnn,
                   rnn_num_layers=d.rnn_num_layers, rnn_bidirectional=d.rnn_bidirectional,
                   causal=d.causal, antialias=d.antialias, generator=generator)

    def __init__(self, *, in_channels=1024, upsample_initial_channel=1536,
                 up_ratios=(5, 5, 2, 2, 2), dilations=(1, 3, 9), use_rnn=True,
                 rnn_num_layers=2, rnn_bidirectional=False, causal=False,
                 antialias=False, generator: torch.Generator):
        super().__init__()
        self.up_ratios, self.dilations = tuple(up_ratios), tuple(dilations)
        self.causal, self.antialias = causal, antialias
        ch = upsample_initial_channel
        self.conv_in = init_wn_conv1d(in_channels, ch, 7, generator=generator)
        self.lstm = None
        if use_rnn:
            hid = ch if not rnn_bidirectional else ch // 2
            self.lstm = init_lstm(ch, hid, num_layers=rnn_num_layers,
                                  bidirectional=rnn_bidirectional, generator=generator)
        self.blocks = nn.ModuleList(
            DecoderBlock(ch // 2 ** i, ch // 2 ** (i + 1), stride, len(self.dilations),
                         causal=causal, antialias=antialias, generator=generator)
            for i, stride in enumerate(self.up_ratios))
        out_dim = ch // 2 ** len(self.up_ratios)
        self.snake_out = SnakeBeta(out_dim)
        self.conv_out = init_wn_conv1d(out_dim, 1, 7, generator=generator)

    def forward(self, x, *, frames=None, remat: bool = False):
        """``frames``: (B,) frame counts of a ragged batch, each sample
        decoded as its own frames decode alone; ``remat`` as in the
        encoder."""
        if frames is None:
            return bigcodec_decode(self, x, remat=remat)
        return masked_decode(self, x, frames)


def _block(fn, x, block, *, remat: bool, **kwargs):
    """``fn(x, block)``, recomputed in the backward with ``remat``; one FSDP
    block (``parallel/fsdp.py::run_block``)."""
    if remat:
        return run_block(block, checkpointed, fn, block, x, **kwargs)
    return run_block(block, fn, x, block, **kwargs)


def encode_front(p: BigCodecEncoder, x, *, remat: bool = False):
    """conv_in and the encoder blocks: (B, 1, T) -> (B, C, T / hop)."""
    aa = _AA(p.antialias)
    x = _wn_conv(x, p.conv_in, padding=3, causal=p.causal)
    for block, stride in zip(p.blocks, p.up_ratios):
        x = _block(encoder_block, x, block, remat=remat, stride=stride,
                   dilations=p.dilations, aa=aa)
    return x


def encode_tail(p: BigCodecEncoder, x):
    """ResLSTM, snake_out and conv_out over the front's frames."""
    if p.lstm is not None:
        x = run_block(p.lstm, res_lstm, x, p.lstm)
    x = _AA(p.antialias)(x, p.snake_out)
    return _wn_conv(x, p.conv_out, padding=1, causal=p.causal)


def bigcodec_encode(p: BigCodecEncoder, x, *, remat: bool = False):
    """x: (B, 1, T) waveform -> (B, out_channels, T / hop) latents. remat:
    each EncoderBlock's activations are recomputed in the backward."""
    return encode_tail(p, encode_front(p, x, remat=remat))


def bigcodec_decode(p: BigCodecDecoder, x, *, remat: bool = False):
    """x: (B, in_channels, Tf) quantized latents -> (B, 1, T) waveform.
    remat: as in ``bigcodec_encode``, per DecoderBlock."""
    aa = _AA(p.antialias)
    x = _wn_conv(x, p.conv_in, padding=3, causal=p.causal)
    if p.lstm is not None:
        x = run_block(p.lstm, res_lstm, x, p.lstm)
    for block, stride in zip(p.blocks, p.up_ratios):
        x = _block(decoder_block, x, block, remat=remat, stride=stride,
                   dilations=p.dilations, aa=aa)
    x = aa(x, p.snake_out)
    return torch.tanh(_wn_conv(x, p.conv_out, padding=3, causal=p.causal))


# -- ragged batches: each sample's tail re-zeroed (module docstring) ------------------


def edge_mask(x, bound):
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


class MaskedAA:
    """Activation1d with per-sample tails. Without anti-aliasing a plain
    snake (snake(0) = 0 keeps the zero tail). With it: replicate the tail,
    2x upsample, snake, replicate the upsampled tail (the per-file
    downsample pads with the edge value, not the interpolation past it),
    2x downsample, then re-zero the tail for the next conv's zero padding.
    bound: (B,) valid positions at this stride scale."""

    def __init__(self, antialias: bool, bound):
        self._aa = _AA(antialias)
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
        return edge_mask(x, b)


def masked_front(enc: BigCodecEncoder, x, lengths):
    """``encode_front`` of a ragged batch: x (B, 1, L), lengths (B,)
    samples -> (B, C, L / hop), each sample's tail re-zeroed after every
    conv and unit."""
    x = _wn_conv(x, enc.conv_in, padding=3, causal=enc.causal)
    S = 1
    x = edge_mask(x, lengths)
    for block, stride in zip(enc.blocks, enc.up_ratios):
        aa = MaskedAA(enc.antialias, lengths // S)
        for unit, d in zip(block.units, enc.dilations):
            x = edge_mask(residual_unit(x, unit, dilation=d, aa=aa), lengths // S)
        x = aa(x, block.snake)
        if stride != 1:
            x = _wn_conv(x, block.down, stride=stride, padding=stride // 2 + stride % 2,
                         causal=enc.causal)
        else:
            x = _wn_conv(x, block.down)
        S *= stride
        x = edge_mask(x, lengths // S)
    return x


def masked_tail(enc: BigCodecEncoder, lat, lengths):
    """``encode_tail`` of a ragged batch over ``masked_front``'s latents."""
    frames = lengths // math.prod(enc.up_ratios)
    if enc.lstm is not None:
        lat = res_lstm(lat, enc.lstm, valid=_frame_valid(frames, lat.shape[-1]))
    lat = edge_mask(lat, frames)  # the tail conv reads past each sample's last frame
    lat = MaskedAA(enc.antialias, frames)(lat, enc.snake_out)
    return _wn_conv(lat, enc.conv_out, padding=1, causal=enc.causal)


def masked_decode(dec: BigCodecDecoder, z, frames):
    """``bigcodec_decode`` of a ragged batch: z (B, C, L) with (B,) frame
    counts -> (B, 1, L · hop), each sample's tail re-zeroed after every
    spatial op."""
    x = edge_mask(_wn_conv(z, dec.conv_in, padding=3, causal=dec.causal), frames)
    if dec.lstm is not None:
        x = res_lstm(x, dec.lstm, valid=_frame_valid(frames, x.shape[-1]))
        x = edge_mask(x, frames)
    S = 1
    for block, stride in zip(dec.blocks, dec.up_ratios):
        x = MaskedAA(dec.antialias, frames * S)(x, block.snake)
        if stride != 1:
            x = _wn_tconv(x, block.up, stride=stride, padding=stride // 2 + stride % 2,
                          output_padding=stride % 2, causal=dec.causal)
        else:
            x = _wn_tconv(x, block.up)
        S *= stride
        x = edge_mask(x, frames * S)
        aa = MaskedAA(dec.antialias, frames * S)
        for unit, d in zip(block.units, dec.dilations):
            x = edge_mask(residual_unit(x, unit, dilation=d, aa=aa), frames * S)
    x = MaskedAA(dec.antialias, frames * S)(x, dec.snake_out)
    x = _wn_conv(x, dec.conv_out, padding=3, causal=dec.causal)
    return torch.tanh(x)
