"""STFT and mel filterbanks with torch.stft semantics (counterpart of
``audiotokenization_tpu/ops/stft.py``, the parts the GAN losses and the
spectrogram discriminator use).

- ``stft``: center padding by numpy-style reflection, a window shorter than
  n_fft zero-padded to it, centred; complex (..., n_fft//2 + 1, frames).
- ``stft_magnitude``: the discriminator's sqrt(clip(re² + im², 1e-7, 1e3)),
  (B, frames, F).
- ``mel_filterbank``: slaney scale and slaney area norm (torchaudio's
  ``melscale_fbanks(norm='slaney', mel_scale='slaney')``), built in numpy.
- ``mel_spectrogram``: the magnitude mel of ``torchaudio.transforms.
  MelSpectrogram(center=True, norm/scale slaney)``, for the eval images;
- ``stft_same_constant_pad``: the Conformer encoder's front, center=False
  after (win - hop) / 2 zeros on both sides;
- ``istft_same``: the Conformer decoder's "same"-padded inverse: irfft,
  window, overlap-add, division by the overlap-added squared window (the
  NOLA envelope) and a (win - hop) / 2 trim on both sides. ``torch.istft``
  cannot trim this way nor take a per-sample envelope, so the overlap-add
  is written out (``overlap_add``).

The spectral math runs in fp32 whatever the input dtype.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=64)
def hann_window(win_length: int, *, device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """torch.hann_window's default (periodic), computed in float64 then fp32;
    cached per device (treat it as read-only)."""
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win_length) / max(win_length, 1))
    return torch.tensor(w, dtype=torch.float32, device=device)


def reflect_pad(x, pad: int):
    """numpy's (and jnp.pad's) 'reflect' padding of the last axis by ``pad``
    on both sides, also where pad >= T (the reflection repeats), which
    F.pad refuses: a gather along the triangle wave of period 2(T - 1)."""
    return x[..., _reflect_index(x.shape[-1], pad, x.device)]


@functools.lru_cache(maxsize=64)
def _reflect_index(T: int, pad: int, device: torch.device) -> torch.Tensor:
    """Cached per shape and device: a step would otherwise copy it to the
    card once per call."""
    i = np.abs(np.arange(-pad, T + pad)) % max(2 * (T - 1), 1)
    i = np.where(i >= T, 2 * (T - 1) - i, i)
    return torch.from_numpy(i).to(device)


def stft(x, *, n_fft: int, hop_length: int, win_length: int | None = None,
         window=None, center: bool = True):
    """x (..., T) -> complex64 (..., n_fft // 2 + 1, frames)."""
    win_length = win_length or n_fft
    if window is None:
        window = hann_window(win_length, device=x.device)
    if win_length < n_fft:  # zero-padded to n_fft, centred, as torch.stft does
        left = (n_fft - win_length) // 2
        window = F.pad(window, (left, n_fft - win_length - left))
    x = x.float()
    lead = x.shape[:-1]
    x = x.reshape(-1, x.shape[-1])
    if center:
        x = reflect_pad(x, n_fft // 2)
    spec = torch.stft(x, n_fft, hop_length=hop_length, win_length=n_fft,
                      window=window.to(x.device), center=False, return_complex=True)
    return spec.reshape(*lead, *spec.shape[-2:])


def power(spec):
    """re² + im² of a complex tensor, differentiable everywhere (|z|² has
    gradient 0 at z = 0)."""
    ri = torch.view_as_real(spec)
    return ri[..., 0] ** 2 + ri[..., 1] ** 2


def stft_magnitude(x, *, n_fft: int, hop_length: int, win_length: int,
                   clamp_min: float = 1e-7, clamp_max: float = 1e3):
    """(B, T) -> (B, frames, F): sqrt(clip(re² + im², 1e-7, 1e3)), center=True."""
    s = stft(x, n_fft=n_fft, hop_length=hop_length, win_length=win_length)
    return torch.sqrt(torch.clamp(power(s), clamp_min, clamp_max)).transpose(-1, -2)


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    logstep = np.log(6.4) / 27.0
    with np.errstate(divide="ignore"):  # f == 0 takes the linear branch
        return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-30) / 1000.0) / logstep,
                        3.0 * f / 200.0)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    logstep = np.log(6.4) / 27.0
    return np.where(m >= 15.0, 1000.0 * np.exp(logstep * (m - 15.0)), 200.0 * m / 3.0)


def mel_filterbank(*, sample_rate: int, n_fft: int, n_mels: int) -> np.ndarray:
    """Slaney-scale, slaney-normed mel matrix (n_mels, n_fft // 2 + 1) from 0
    Hz to Nyquist, fp32."""
    all_freqs = np.linspace(0, sample_rate / 2.0, n_fft // 2 + 1)
    f_pts = _mel_to_hz_slaney(np.linspace(_hz_to_mel_slaney(0.0),
                                          _hz_to_mel_slaney(sample_rate / 2.0), n_mels + 2))
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]  # (n_freqs, n_mels + 2)
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    fb = fb * (2.0 / (f_pts[2:n_mels + 2] - f_pts[:n_mels]))[None, :]
    return fb.T.astype(np.float32)


def mel_spectrogram(x, *, sample_rate: int, n_fft: int, hop_length: int, n_mels: int,
                    power: float = 1.0):
    """x (..., T) -> (..., n_mels, frames): the mel of |STFT|^power, a Hann
    window of n_fft, center=True with reflection (JAX ``ops/stft.py::
    mel_spectrogram`` from 0 Hz to Nyquist)."""
    fb = torch.from_numpy(mel_filterbank(sample_rate=sample_rate, n_fft=n_fft,
                                         n_mels=n_mels)).to(x.device)
    ri = torch.view_as_real(stft(x, n_fft=n_fft, hop_length=hop_length))
    mag = torch.sqrt(torch.clamp_min(ri[..., 0] ** 2 + ri[..., 1] ** 2, 1e-20))
    if power != 1.0:
        mag = mag ** power
    return torch.einsum("mf,...ft->...mt", fb, mag)


def stft_same_constant_pad(x, *, n_fft: int, hop_length: int, win_length: int, window=None):
    """x (B, T) -> complex64 (B, n_fft // 2 + 1, frames): (win - hop) / 2
    zeros on both sides, then center=False, so T / hop frames for T a
    multiple of hop."""
    pad = (win_length - hop_length) // 2
    return stft(F.pad(x.float(), (pad, pad)), n_fft=n_fft, hop_length=hop_length,
                win_length=win_length, window=window, center=False)


def overlap_add(frames, hop: int):
    """frames (B, T, W) -> (B, (T - 1) · hop + W): out[t · hop + j] +=
    frames[t, j]. Each frame splits into ceil(W / hop) hop-long strips;
    strip s of frame t lands on hop block t + s, added strip by strip in
    the JAX package's order."""
    B, T, W = frames.shape
    n = -(-W // hop)
    strips = F.pad(frames, (0, n * hop - W)).reshape(B, T, n, hop)
    out = frames.new_zeros(B, T + n - 1, hop)
    for s in range(n):
        out[:, s:s + T] += strips[:, :, s]
    return out.reshape(B, -1)[:, :(T - 1) * hop + W]


def istft_same(spec, *, n_fft: int, hop_length: int, win_length: int, window=None,
               valid=None):
    """complex (B, F, T) -> (B, T · hop): the "same"-padded ISTFT.

    ``valid``: optional (B,) frame counts of a ragged batch. Each sample's
    frames past its count add nothing, and its envelope sums its own
    frames only, clamped at float32's smallest normal where it is 0; so
    each sample equals its own ISTFT, and positions past its end are
    meaningless."""
    if window is None:
        window = hann_window(win_length, device=spec.device)
    pad = (win_length - hop_length) // 2
    T = spec.shape[-1]
    frames = (torch.fft.irfft(spec, n=n_fft, dim=1) * window[None, :, None]).transpose(1, 2)
    w2 = window * window
    if valid is None:
        out = overlap_add(frames, hop_length)
        env = overlap_add(w2.expand(1, T, -1), hop_length)
    else:
        keep = (torch.arange(T, device=spec.device)[None, :]
                < valid[:, None]).to(frames.dtype)[:, :, None]
        out = overlap_add(frames * keep, hop_length)
        env = overlap_add(w2 * keep, hop_length).clamp_min(torch.finfo(frames.dtype).tiny)
    if pad > 0:
        out, env = out[:, pad:-pad], env[:, pad:-pad]
    return out / env
