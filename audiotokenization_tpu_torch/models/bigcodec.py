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
(``utils/ragged.py::_MaskedAA``, ``parallel/sp.py::_SPAA``).

Init: the reference's weight-normed convs effectively start from torch's
default (kaiming-uniform v, g = ‖v‖) with zeroed biases; transpose convs
keep torch's default bias.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.alias_free import activation1d
from ..ops.conv import (causal_conv1d, causal_conv_transpose1d, conv1d, conv_transpose1d,
                        init_wn_conv1d, init_wn_conv_transpose1d)
from ..ops.cuda.residual_unit_kernel import fused_residual_unit
from ..ops.lstm import init_lstm, res_lstm
from ..ops.params import checkpointed
from ..ops.snake import SnakeBeta, snake_beta


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

    def forward(self, x):
        return bigcodec_encode(self, x)


class BigCodecDecoder(nn.Module):
    """quantized latents (B, in_channels, Tf) -> waveform (B, 1, Tf · hop)."""

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

    def forward(self, x):
        return bigcodec_decode(self, x)


def _block(fn, x, block, *, remat: bool, **kwargs):
    if remat:
        return checkpointed(fn, block, x, **kwargs)
    return fn(x, block, **kwargs)


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
        x = res_lstm(x, p.lstm)
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
        x = res_lstm(x, p.lstm)
    for block, stride in zip(p.blocks, p.up_ratios):
        x = _block(decoder_block, x, block, remat=remat, stride=stride,
                   dilations=p.dilations, aa=aa)
    x = aa(x, p.snake_out)
    return torch.tanh(_wn_conv(x, p.conv_out, padding=3, causal=p.causal))
