"""Polyphase windowed-sinc resampler (counterpart of
``audiotokenization_tpu/ops/resample.py``), built as torchaudio's
``Resample`` builds its kernel: gcd-reduced rates, lowpass_filter_width 6,
rolloff 0.99, a Hann (cos²) windowed sinc, one filter phase per output
sample of the upsampling cycle, applied as a strided ``conv1d``. The data
loader runs it on the host, for files whose rate is not the config's.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _resample_kernel(orig_freq: int, new_freq: int, *,
                     lowpass_filter_width: int = 6, rolloff: float = 0.99):
    base_freq = min(orig_freq, new_freq) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)
    idx = np.arange(-width, width + orig_freq, dtype=np.float64)[None, None] / orig_freq
    t = np.arange(0, -new_freq, -1, dtype=np.float64)[:, None, None] / new_freq + idx
    t *= base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * math.pi / lowpass_filter_width / 2) ** 2
    t *= math.pi
    scale = base_freq / orig_freq
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernel = kernel * window * scale
    return kernel.astype(np.float32), width


def resample(x, orig_freq: int, new_freq: int, *, lowpass_filter_width: int = 6,
             rolloff: float = 0.99):
    """x: tensor or array (..., T) -> float32 tensor (..., ceil(T·new/orig)),
    on x's device. Returns x unchanged if the rates match."""
    if orig_freq == new_freq:
        return x
    g = math.gcd(int(orig_freq), int(new_freq))
    of, nf = int(orig_freq) // g, int(new_freq) // g
    kernel, width = _resample_kernel(of, nf, lowpass_filter_width=lowpass_filter_width,
                                     rolloff=rolloff)
    x = torch.as_tensor(x)
    shape = x.shape
    T = shape[-1]
    xr = F.pad(x.reshape(-1, 1, T).float(), (width, width + of))
    y = F.conv1d(xr, torch.from_numpy(kernel).to(xr.device), stride=of)  # (B, nf, ·)
    y = y.transpose(1, 2).reshape(xr.shape[0], -1)
    target_len = int(math.ceil(nf * T / of))
    return y[:, :target_len].reshape(shape[:-1] + (target_len,))
