"""The w2v-bert-2.0 input features (SeamlessM4T's feature extractor), the
port's own copy of ``audiotokenization_tpu/ops/fbank.py``.

The pipeline, per utterance:

  1. scale the waveform by 2^15 (kaldi 16-bit convention);
  2. frame: 400-sample windows, hop 160, no centering
     (nf = 1 + floor((T - 400)/160));
  3. per frame: subtract the frame mean, preemphasis 0.97 (the first sample
     scaled by 1 - 0.97), the non-periodic povey window (hann^0.85,
     denominator N - 1);
  4. power spectrum through a 512-point rfft;
  5. the kaldi-scale 80-bin mel filter bank (mel = 1127 ln(1 + f/700), fmin
     20, fmax 8000, no norm, triangles in mel space), floored at
     1.192092955078125e-07, natural log;
  6. per mel bin, zero mean and unit variance over the utterance's frames
     (ddof=1, eps 1e-7);
  7. zero-pad the frame count to a multiple of 2 and stack frame pairs ->
     (nf // 2, 160).

``w2v_bert_features`` is the numpy extractor (float64 inside, the
dataloader's, bit for bit the JAX package's); ``w2v_bert_features_torch``
is the batched fp32 version on the tensor's device (``torch.fft.rfft``;
~1e-4 off the numpy one after the log and the normalisation).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

_SAMPLE_RATE = 16000
_FRAME = 400
_HOP = 160
_NFFT = 512
_NMELS = 80
_PREEMPH = 0.97
_MEL_FLOOR = 1.192092955078125e-07
_STRIDE = 2
CLIP_PAD = 160  # samples of zeros each side of a clip before extraction


def _mel_kaldi(f):
    return 1127.0 * np.log1p(np.asarray(f, np.float64) / 700.0)


def kaldi_mel_filters(*, n_freqs: int = _NFFT // 2 + 1, n_mels: int = _NMELS,
                      fmin: float = 20.0, fmax: float = _SAMPLE_RATE / 2,
                      sample_rate: int = _SAMPLE_RATE) -> np.ndarray:
    """(n_freqs, n_mels) kaldi-scale triangular filters, triangles in mel space."""
    bin_mels = _mel_kaldi(np.arange(n_freqs) * sample_rate / ((n_freqs - 1) * 2))
    pts = np.linspace(_mel_kaldi(fmin), _mel_kaldi(fmax), n_mels + 2)
    left, center, right = pts[:-2], pts[1:-1], pts[2:]
    up = (bin_mels[:, None] - left[None, :]) / (center - left)[None, :]
    down = (right[None, :] - bin_mels[:, None]) / (right - center)[None, :]
    return np.maximum(0.0, np.minimum(up, down))


def povey_window(n: int = _FRAME) -> np.ndarray:
    """Non-periodic povey window: hann((N-1)-denominator)^0.85."""
    i = np.arange(n, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * i / (n - 1))) ** 0.85


_FILTERS = None
_WINDOW = None


def _tables():
    # _WINDOW is assigned last: a loader thread that sees it set also sees
    # _FILTERS; a double computation while both are None is harmless
    global _FILTERS, _WINDOW
    if _WINDOW is None:
        _FILTERS = kaldi_mel_filters()
        _WINDOW = povey_window()
    return _FILTERS, _WINDOW


def fbank(wav: np.ndarray) -> np.ndarray:
    """wav (T,) float in [-1, 1] -> (nf, 80) float32 log-mel (kaldi fbank)."""
    filters, window = _tables()
    x = np.asarray(wav, np.float64) * 32768.0
    if len(x) < _FRAME:
        return np.zeros((0, _NMELS), np.float32)
    nf = 1 + (len(x) - _FRAME) // _HOP
    frames = np.lib.stride_tricks.sliding_window_view(x, _FRAME)[::_HOP][:nf]
    frames = frames - frames.mean(axis=1, keepdims=True)
    pre = np.empty_like(frames)
    pre[:, 1:] = frames[:, 1:] - _PREEMPH * frames[:, :-1]
    pre[:, 0] = frames[:, 0] * (1.0 - _PREEMPH)
    spec = np.abs(np.fft.rfft(pre * window, _NFFT)) ** 2
    mel = np.maximum(_MEL_FLOOR, spec @ filters)
    return np.log(mel).astype(np.float32)


def w2v_bert_features(wav: np.ndarray) -> np.ndarray:
    """wav (T,) -> (nf', 160) float32 stacked, normalised w2v-bert input of
    one utterance (the frame count zero-padded to a multiple of 2)."""
    f = fbank(wav)
    if len(f) == 0:
        return np.zeros((0, _NMELS * _STRIDE), np.float32)
    f = (f - f.mean(0, keepdims=True)) / np.sqrt(f.var(0, ddof=1, keepdims=True) + 1e-7)
    f = f.astype(np.float32)
    if len(f) % _STRIDE:
        f = np.pad(f, ((0, _STRIDE - len(f) % _STRIDE), (0, 0)))
    return f.reshape(len(f) // _STRIDE, _NMELS * _STRIDE)


def w2v_bert_features_from_clip(wav: np.ndarray) -> np.ndarray:
    """The dataset's entry: the clip padded by 160 zeros each side, then
    ``w2v_bert_features``."""
    return w2v_bert_features(np.pad(np.asarray(wav), (CLIP_PAD, CLIP_PAD)))


def feature_frames(samples: int) -> int:
    """The stacked feature frames of a clip of ``samples`` samples
    (``w2v_bert_features_from_clip``'s)."""
    n = samples + 2 * CLIP_PAD
    if n < _FRAME:
        return 0
    return -(-(1 + (n - _FRAME) // _HOP) // _STRIDE)


@functools.lru_cache(maxsize=16)
def _torch_tables(device: torch.device):
    """The mel filters and the window as fp32 tensors, cached per device
    (treat them as read-only)."""
    filters, window = _tables()
    return (torch.tensor(filters, dtype=torch.float32, device=device),
            torch.tensor(window, dtype=torch.float32, device=device))


def w2v_bert_features_torch(wav, *, pad_clip: bool = True):
    """Batched fp32 version on ``wav``'s device: wav (B, T) -> (B, nf', 160),
    every row of the same length T (a fixed-crop batch). ``pad_clip``: the
    160-zero pad on each side first, as ``w2v_bert_features_from_clip``."""
    filters, window = _torch_tables(wav.device)
    x = wav.float()
    if pad_clip:
        x = torch.nn.functional.pad(x, (CLIP_PAD, CLIP_PAD))
    x = x * 32768.0
    nf = 1 + (x.shape[-1] - _FRAME) // _HOP
    frames = x.unfold(-1, _FRAME, _HOP)[:, :nf]  # (B, nf, 400)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    pre = torch.cat([frames[..., :1] * (1.0 - _PREEMPH),
                     frames[..., 1:] - _PREEMPH * frames[..., :-1]], dim=-1)
    spec = torch.fft.rfft(pre * window, _NFFT).abs() ** 2
    f = torch.log(torch.clamp(spec @ filters, min=_MEL_FLOOR))  # (B, nf, 80)
    mu = f.mean(dim=1, keepdim=True)
    var = ((f - mu) ** 2).sum(dim=1, keepdim=True) / max(nf - 1, 1)  # ddof=1
    f = (f - mu) / torch.sqrt(var + 1e-7)
    if nf % _STRIDE:
        f = torch.nn.functional.pad(f, (0, 0, 0, _STRIDE - nf % _STRIDE))
    return f.reshape(f.shape[0], f.shape[1] // _STRIDE, _NMELS * _STRIDE)
