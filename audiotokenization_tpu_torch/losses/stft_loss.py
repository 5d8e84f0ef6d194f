"""Multi-resolution STFT loss, spectral convergence plus log magnitude
(counterpart of ``audiotokenization_tpu/losses/stft_loss.py``; off unless
``train.use_stft_loss``):

    L = Σ_res ‖|S(y)| - |S(x)|‖_F / ‖|S(y)|‖_F + mean |log|S(y)| - log|S(x)||

The norms are over the whole batch: in a data-parallel step
(``parallel/dp.py``) their squares are summed over the ranks.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..ops.stft import power, stft
from ..parallel import dp


def _norm(t):
    """‖t‖_F, over the global batch in a data-parallel step."""
    group = dp.active_group()
    if group is None:
        return torch.linalg.vector_norm(t)
    return torch.sqrt(dp.global_sum(torch.sum(torch.square(t)), group))


def multi_resolution_stft_loss(x, y, *,
                               fft_sizes: Sequence[int] = (128, 256, 512, 1024, 2048),
                               hop_sizes: Sequence[int] = (32, 64, 128, 256, 512),
                               win_lengths: Sequence[int] = (128, 256, 512, 1024, 2048),
                               eps: float = 1e-7):
    """x, y: (B, T) generated / target waveforms -> scalar loss."""
    loss = 0.0
    for nf, hp, wl in zip(fft_sizes, hop_sizes, win_lengths):
        mx = torch.sqrt(torch.clamp_min(power(stft(x, n_fft=nf, hop_length=hp,
                                                   win_length=wl)), eps))
        my = torch.sqrt(torch.clamp_min(power(stft(y, n_fft=nf, hop_length=hp,
                                                   win_length=wl)), eps))
        sc = _norm(my - mx) / torch.clamp_min(_norm(my), eps)
        loss = loss + sc + torch.mean(torch.abs(torch.log(my) - torch.log(mx)))
    return loss
