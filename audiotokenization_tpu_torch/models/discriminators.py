"""GAN discriminators: the HiFi-GAN multi-period discriminator (MPD) and the
multi-resolution spectrogram discriminator (counterpart of
``audiotokenization_tpu/models/discriminators.py``).

- MPD, one sub-discriminator per period (2, 3, 5, 7, 11): (B, 1, T)
  reflect-padded to a multiple of p and folded to (B, 1, T/p, p); five
  (5, 1) convs with strides 3, 3, 3, 3, 1 and padding (2, 0), channels
  16 -> 64 -> 256 -> 512 -> 512, LeakyReLU 0.1; a (2, 1) output conv.
- Spectrogram discriminator, one per resolution (fft 128..2048): the
  magnitude STFT (fp32, then the weights' dtype) as (B, 1, F, frames);
  a k5 stride-2 stem, three k5 stride-2 stages (channels x2, capped at
  512), a k3 conv, LeakyReLU 0.2 after each, and a k3 output conv.

Each returns, per sub-discriminator, every feature map plus the logits
(the MPD's flattened to (B, -1)). Every conv is weight-normed, initialised
as torch does by default. Parameter names follow the JAX tree:
``mpd.discs.<i>.convs.<j>.{v,g,b}``, ``mpd.discs.<i>.out``,
``spec.discs.<i>.layers.<j>``.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config
from ..ops.conv import conv2d, get_weight, init_wn_conv2d
from ..ops.stft import reflect_pad, stft_magnitude
from ..parallel.fsdp import run_block


class PeriodDiscriminator(nn.Module):
    def __init__(self, *, channels=16, channel_increasing_factor=4,
                 max_downsample_channels=512, downsample_scales=(3, 3, 3, 3, 1),
                 kernel_sizes=(5, 3), generator: torch.Generator):
        super().__init__()
        convs, cin, cout = [], 1, channels
        for _ in downsample_scales:
            convs.append(init_wn_conv2d(cin, cout, (kernel_sizes[0], 1), generator=generator))
            cin, cout = cout, min(cout * channel_increasing_factor, max_downsample_channels)
        self.convs = nn.ModuleList(convs)
        self.out = init_wn_conv2d(cin, 1, (kernel_sizes[1] - 1, 1), generator=generator)


def period_discriminator(p: PeriodDiscriminator, x, *, period: int,
                         downsample_scales=(3, 3, 3, 3, 1), slope: float = 0.1):
    """x (B, 1, T) -> [5 feature maps, logits (B, -1)]."""
    B, C, T = x.shape
    if T % period:
        n_pad = period - T % period
        x = torch.cat([x, reflect_pad(x, n_pad)[..., -n_pad:]], dim=-1)  # right side only
        T += n_pad
    x = x.reshape(B, C, T // period, period)
    outs = []
    for conv, scale in zip(p.convs, downsample_scales):
        x = F.leaky_relu(conv2d(x, conv, stride=(scale, 1), padding=(2, 0)), slope)
        outs.append(x)
    outs.append(conv2d(x, p.out, padding=(1, 0)).reshape(B, -1))
    return outs


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, *, periods=(2, 3, 5, 7, 11), channels=16,
                 channel_increasing_factor=4, max_downsample_channels=512,
                 generator: torch.Generator):
        super().__init__()
        self.periods = tuple(periods)
        self.discs = nn.ModuleList(
            PeriodDiscriminator(channels=channels,
                                channel_increasing_factor=channel_increasing_factor,
                                max_downsample_channels=max_downsample_channels,
                                generator=generator)
            for _ in self.periods)


def mpd_apply(p: MultiPeriodDiscriminator, x) -> List[List[torch.Tensor]]:
    return [run_block(d, period_discriminator, d, x, period=period)
            for d, period in zip(p.discs, p.periods)]


class SpecDiscriminator(nn.Module):
    """One resolution's conv pyramid (``layers``)."""

    def __init__(self, *, channels=32, max_downsample_channels=512,
                 downsample_scales=(2, 2, 2), kernel_sizes=(5, 3),
                 generator: torch.Generator):
        super().__init__()
        layers = [init_wn_conv2d(1, channels, (kernel_sizes[0],) * 2, generator=generator)]
        cin = channels
        for scale in downsample_scales:
            cout = min(cin * scale, max_downsample_channels)
            layers.append(init_wn_conv2d(cin, cout, (2 * scale + 1,) * 2, generator=generator))
            cin = cout
        cout = min(cin * 2, max_downsample_channels)
        layers.append(init_wn_conv2d(cin, cout, (kernel_sizes[1],) * 2, generator=generator))
        layers.append(init_wn_conv2d(cout, 1, (kernel_sizes[1],) * 2, generator=generator))
        self.layers = nn.ModuleList(layers)


def _ksize(p) -> int:
    return get_weight(p).shape[-1]


def nlayer_spec_discriminator(p: SpecDiscriminator, spec, *, downsample_scales=(2, 2, 2)):
    """spec (B, 1, F, frames) -> per-layer features + logits."""
    k0 = _ksize(p.layers[0])
    x = F.leaky_relu(conv2d(spec, p.layers[0], stride=(2, 2), padding=(k0 // 2,) * 2), 0.2)
    outs = [x]
    for i, scale in enumerate(downsample_scales):
        x = F.leaky_relu(conv2d(x, p.layers[1 + i], stride=(scale,) * 2,
                                padding=(scale,) * 2), 0.2)
        outs.append(x)
    n = len(downsample_scales)
    for j, final in ((n + 1, False), (n + 2, True)):
        kj = _ksize(p.layers[j])
        x = conv2d(x, p.layers[j], padding=(kj // 2,) * 2)
        if not final:
            x = F.leaky_relu(x, 0.2)
        outs.append(x)
    return outs


class MultiResolutionSpecDiscriminator(nn.Module):
    def __init__(self, *, fft_sizes=(128, 256, 512, 1024, 2048),
                 hop_sizes=(32, 64, 128, 256, 512), win_lengths=(128, 256, 512, 1024, 2048),
                 channels=32, max_downsample_channels=512, downsample_scales=(2, 2, 2),
                 generator: torch.Generator):
        super().__init__()
        self.resolutions = tuple(zip(fft_sizes, hop_sizes, win_lengths))
        self.downsample_scales = tuple(downsample_scales)
        self.discs = nn.ModuleList(
            SpecDiscriminator(channels=channels, max_downsample_channels=max_downsample_channels,
                              downsample_scales=downsample_scales, generator=generator)
            for _ in self.resolutions)


def spec_discriminator_apply(p: MultiResolutionSpecDiscriminator, x):
    """x (B, 1, T) -> per resolution, the feature list."""
    def one(d, nf, hp, wl):
        mag = stft_magnitude(x[:, 0, :], n_fft=nf, hop_length=hp, win_length=wl)
        spec = mag.to(get_weight(d.layers[0]).dtype).transpose(1, 2)[:, None]
        return nlayer_spec_discriminator(d, spec, downsample_scales=p.downsample_scales)

    return [run_block(d, one, d, *res) for d, res in zip(p.discs, p.resolutions)]


class Discriminator(nn.Module):
    """Both discriminators, ``mpd`` and ``spec``, as the JAX tree holds them."""

    def __init__(self, cfg: Config, *, generator: torch.Generator):
        super().__init__()
        m = cfg.model
        self.mpd = MultiPeriodDiscriminator(
            periods=m.mpd.periods, channels=m.mpd.channels,
            channel_increasing_factor=m.mpd.channel_increasing_factor,
            max_downsample_channels=m.mpd.max_downsample_channels, generator=generator)
        sp = m.mstft.stft_params
        self.spec = MultiResolutionSpecDiscriminator(
            fft_sizes=sp.fft_sizes, hop_sizes=sp.hop_sizes, win_lengths=sp.win_lengths,
            channels=m.mstft.channels, max_downsample_channels=m.mstft.max_downsample_channels,
            downsample_scales=m.mstft.downsample_scales, generator=generator)


def discriminator_apply(x, p: Discriminator):
    """x (B, 1, T) -> the MPD's feature lists, then the spectrogram
    discriminator's (argument order as ``ops.params.checkpointed`` calls)."""
    return mpd_apply(p.mpd, x) + spec_discriminator_apply(p.spec, x)
