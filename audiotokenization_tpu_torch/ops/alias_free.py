"""Anti-aliased activation (Activation1d): a snake between a 2x upsample
and a 2x downsample through Kaiser-windowed sinc filters.

Counterpart of ``audiotokenization_tpu/ops/alias_free.py`` (the reference's
``alias_free_torch``): the low-pass filter normalised to unit DC gain, the
2x upsample as a replicate-padded depthwise transpose conv, the 2x
downsample as a replicate-padded strided depthwise conv. The filters are
constants computed with numpy, not parameters, so a state dict holds none.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


def kaiser_beta(A: float) -> float:
    if A > 50.0:
        return 0.1102 * (A - 8.7)
    if A >= 21.0:
        return 0.5842 * (A - 21.0) ** 0.4 + 0.07886 * (A - 21.0)
    return 0.0


def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> torch.Tensor:
    """Windowed-sinc low-pass with unit DC gain, float32 (1, 1, K)."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    A = 2.285 * (half_size - 1) * math.pi * (4 * half_width) + 7.95
    window = np.kaiser(kernel_size, kaiser_beta(A))
    time = np.arange(-half_size, half_size) + 0.5 if even else np.arange(kernel_size) - half_size
    if cutoff == 0:
        filt = np.zeros_like(time)
    else:
        filt = 2 * cutoff * window * np.sinc(2 * cutoff * time)
        filt = filt / filt.sum()
    return torch.from_numpy(np.asarray(filt, np.float32).reshape(1, 1, kernel_size))


def make_resample_filters(ratio: int = 2, kernel_size: int | None = None) -> torch.Tensor:
    ks = int(6 * ratio // 2) * 2 if kernel_size is None else kernel_size
    return kaiser_sinc_filter1d(cutoff=0.5 / ratio, half_width=0.6 / ratio, kernel_size=ks)


@functools.lru_cache(maxsize=None)
def resample_filter(ratio: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``make_resample_filters(ratio)`` on ``device`` in ``dtype``, made once
    per (device, dtype): a constant that callers must not write to."""
    return make_resample_filters(ratio).to(device=device, dtype=dtype)


def _depthwise(filt, C: int):
    return filt.expand(C, 1, filt.shape[-1]).contiguous()


def upsample1d(x, filt, ratio: int = 2):
    """x (B, C, T) -> (B, C, ratio·T): replicate pad, depthwise transpose
    conv, trim. ``filt`` (1, 1, K) in x's dtype on x's device."""
    C, K = x.shape[1], filt.shape[-1]
    pad = K // ratio - 1
    pad_left = pad * ratio + (K - ratio) // 2
    pad_right = pad * ratio + (K - ratio + 1) // 2
    x = F.pad(x, (pad, pad), mode="replicate")
    out = ratio * F.conv_transpose1d(x, _depthwise(filt, C), stride=ratio, groups=C)
    return out[..., pad_left:-pad_right]


def lowpass1d(x, filt, *, stride: int = 1):
    """Depthwise low-pass conv with replicate padding (LowPassFilter1d)."""
    C, K = x.shape[1], filt.shape[-1]
    x = F.pad(x, (K // 2 - int(K % 2 == 0), K // 2), mode="replicate")
    return F.conv1d(x, _depthwise(filt, C), stride=stride, groups=C)


def downsample1d(x, filt, ratio: int = 2):
    return lowpass1d(x, filt, stride=ratio)


def activation1d(x, act_fn, *, antialias: bool = False, ratio: int = 2):
    """Activation1d: ``act_fn(x)``, or with ``antialias`` up -> act -> down
    through ``resample_filter(ratio)``."""
    if not antialias:
        return act_fn(x)
    filt = resample_filter(ratio, x.device, x.dtype)
    return downsample1d(act_fn(upsample1d(x, filt, ratio)), filt, ratio)
