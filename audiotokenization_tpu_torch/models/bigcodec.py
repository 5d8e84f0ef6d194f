"""BigCodec convolutional encoder / decoder.

Counterpart of ``audiotokenization_tpu/models/bigcodec.py``, non-causal and
without anti-aliasing (the causal and antialias variants come later).

Encoder: WNConv1d(1 -> ngf, k7) -> 5x EncoderBlock (channels double per
stride of up_ratios = (2, 2, 2, 5, 5)) -> ResLSTM -> SnakeBeta ->
WNConv1d(-> out_channels, k3). Decoder: WNConv1d(-> 1536, k7) -> ResLSTM ->
5x DecoderBlock (transpose conv halving channels) -> SnakeBeta ->
WNConv1d(-> 1, k7) -> tanh. Each block holds 3 ResidualUnits (dilations
1/3/9); on CUDA tensors every unit is one call of kernel K2.

Init: the reference's weight-normed convs effectively start from torch's
default (kaiming-uniform v, g = ‖v‖) with zeroed biases; transpose convs
keep torch's default bias.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.conv import (conv1d, conv_transpose1d, init_wn_conv1d,
                        init_wn_conv_transpose1d)
from ..ops.cuda.residual_unit_kernel import fused_residual_unit
from ..ops.lstm import init_lstm, res_lstm
from ..ops.params import checkpointed
from ..ops.snake import SnakeBeta


def _wn_conv(x, p, *, stride=1, padding=0, dilation=1):
    return conv1d(x, p.weight(), p.b, stride=stride, padding=padding,
                  dilation=dilation)


def _wn_tconv(x, p, *, stride=1, padding=0, output_padding=0):
    return conv_transpose1d(x, p.weight(), p.b, stride=stride, padding=padding,
                            output_padding=output_padding)


class ResidualUnit(nn.Module):
    def __init__(self, dim: int, *, generator: torch.Generator):
        super().__init__()
        self.snake1 = SnakeBeta(dim)
        self.conv1 = init_wn_conv1d(dim, dim, 7, generator=generator)
        self.snake2 = SnakeBeta(dim)
        self.conv2 = init_wn_conv1d(dim, dim, 1, generator=generator)


def residual_unit(x, p: ResidualUnit, *, dilation: int):
    """x + [Snake, WNConv k7 dil, Snake, WNConv k1](x), as one K2 call."""
    return fused_residual_unit(
        x, p.conv1.weight(), p.conv1.b, p.conv2.weight(), p.conv2.b,
        p.snake1.alpha, p.snake1.beta, p.snake2.alpha, p.snake2.beta,
        dilation=dilation)


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, stride: int, n_units: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.units = nn.ModuleList(ResidualUnit(dim // 2, generator=generator)
                                   for _ in range(n_units))
        self.snake = SnakeBeta(dim // 2)
        self.down = init_wn_conv1d(dim // 2, dim, 2 * stride if stride != 1 else 1,
                                   generator=generator)


def encoder_block(x, p: EncoderBlock, *, stride: int, dilations):
    """3 ResidualUnits -> Snake -> strided down conv."""
    for unit, d in zip(p.units, dilations):
        x = residual_unit(x, unit, dilation=d)
    x = p.snake(x)
    if stride != 1:
        return _wn_conv(x, p.down, stride=stride, padding=stride // 2 + stride % 2)
    return _wn_conv(x, p.down)


class DecoderBlock(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, stride: int, n_units: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.snake = SnakeBeta(in_dim)
        self.up = init_wn_conv_transpose1d(in_dim, out_dim,
                                           2 * stride if stride != 1 else 1,
                                           generator=generator)
        self.units = nn.ModuleList(ResidualUnit(out_dim, generator=generator)
                                   for _ in range(n_units))


def decoder_block(x, p: DecoderBlock, *, stride: int, dilations):
    """Snake -> transpose conv -> 3 ResidualUnits."""
    x = p.snake(x)
    if stride != 1:
        x = _wn_tconv(x, p.up, stride=stride, padding=stride // 2 + stride % 2,
                      output_padding=stride % 2)
    else:
        x = _wn_tconv(x, p.up)
    for unit, d in zip(p.units, dilations):
        x = residual_unit(x, unit, dilation=d)
    return x


def _check_variant(causal: bool, antialias: bool):
    if causal or antialias:
        raise NotImplementedError(
            "causal and anti-aliased BigCodec are not ported yet")


class BigCodecEncoder(nn.Module):
    """wav (B, 1, T) -> latents (B, out_channels, T / prod(up_ratios))."""

    def __init__(self, *, ngf=48, up_ratios=(2, 2, 2, 5, 5), dilations=(1, 3, 9),
                 out_channels=1024, use_rnn=True, rnn_num_layers=2,
                 rnn_bidirectional=False, causal=False, antialias=False,
                 generator: torch.Generator):
        super().__init__()
        _check_variant(causal, antialias)
        self.up_ratios, self.dilations = tuple(up_ratios), tuple(dilations)
        self.conv_in = init_wn_conv1d(1, ngf, 7, generator=generator)
        d = ngf
        blocks = []
        for stride in self.up_ratios:
            d *= 2
            blocks.append(EncoderBlock(d, stride, len(self.dilations),
                                       generator=generator))
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
        _check_variant(causal, antialias)
        self.up_ratios, self.dilations = tuple(up_ratios), tuple(dilations)
        ch = upsample_initial_channel
        self.conv_in = init_wn_conv1d(in_channels, ch, 7, generator=generator)
        self.lstm = None
        if use_rnn:
            hid = ch if not rnn_bidirectional else ch // 2
            self.lstm = init_lstm(ch, hid, num_layers=rnn_num_layers,
                                  bidirectional=rnn_bidirectional, generator=generator)
        self.blocks = nn.ModuleList(
            DecoderBlock(ch // 2 ** i, ch // 2 ** (i + 1), stride, len(self.dilations),
                         generator=generator)
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


def bigcodec_encode(p: BigCodecEncoder, x, *, remat: bool = False):
    """x: (B, 1, T) waveform -> (B, out_channels, T / hop) latents. remat:
    each EncoderBlock's activations are recomputed in the backward."""
    x = _wn_conv(x, p.conv_in, padding=3)
    for block, stride in zip(p.blocks, p.up_ratios):
        x = _block(encoder_block, x, block, remat=remat, stride=stride,
                   dilations=p.dilations)
    if p.lstm is not None:
        x = res_lstm(x, p.lstm)
    x = p.snake_out(x)
    return _wn_conv(x, p.conv_out, padding=1)


def bigcodec_decode(p: BigCodecDecoder, x, *, remat: bool = False):
    """x: (B, in_channels, Tf) quantized latents -> (B, 1, T) waveform.
    remat: as in ``bigcodec_encode``, per DecoderBlock."""
    x = _wn_conv(x, p.conv_in, padding=3)
    if p.lstm is not None:
        x = res_lstm(x, p.lstm)
    for block, stride in zip(p.blocks, p.up_ratios):
        x = _block(decoder_block, x, block, remat=remat, stride=stride,
                   dilations=p.dilations)
    x = p.snake_out(x)
    return torch.tanh(_wn_conv(x, p.conv_out, padding=3))
