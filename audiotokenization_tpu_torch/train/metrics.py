"""Evaluation metrics (counterpart of ``audiotokenization_tpu/train/metrics.py``):
SI-SNR / SI-SDR and the codebook statistics on tensors, on any device;
STOI and PESQ on the host, in numpy.

- SI-SNR follows torchmetrics: SI-SDR with zero_mean=True; SI-SDR keeps the
  raw means (zero_mean=False).
- The codebook statistics are accumulators (a count per code), so that the
  loop sums them on the device between log steps.
- STOI follows pystoi's classic (non-extended) algorithm step for step, with
  this package's resampler for the 10 kHz operating rate.
- PESQ (ITU-T P.862): the ITU ``pesq`` package when it is importable, else
  the in-repo P.862 pipeline (``train/pesq_p862.py``); ``pesq_impl`` names
  which one ran.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

_EPS = 1e-8


def si_sdr(est, target, *, zero_mean: bool = False):
    """Scale-invariant SDR, per-sample mean over batch. est/target: (..., T)."""
    est = est.float()
    target = target.float()
    if zero_mean:
        est = est - est.mean(-1, keepdim=True)
        target = target - target.mean(-1, keepdim=True)
    alpha = ((est * target).sum(-1, keepdim=True) + _EPS) / (
        (target * target).sum(-1, keepdim=True) + _EPS)
    s_target = alpha * target
    noise = est - s_target
    ratio = ((s_target ** 2).sum(-1) + _EPS) / ((noise ** 2).sum(-1) + _EPS)
    return torch.mean(10.0 * torch.log10(ratio))


def si_snr(est, target):
    """torchmetrics ScaleInvariantSignalNoiseRatio == SI-SDR with zero_mean."""
    return si_sdr(est, target, zero_mean=True)


def masked_si(est, target, lengths, *, zero_mean: bool):
    """Per-sample SI-SDR/SI-SNR over zero-padded ragged batches.

    est/target: (B, L), anything beyond lengths (B,). Means and sums run over
    each row's valid region only, so each row equals the metric on its
    trimmed pair. Returns (B,).
    """
    est = est.float()
    target = target.float()
    mask = (torch.arange(est.shape[-1], device=est.device)[None]
            < lengths[:, None]).float()
    n = torch.clamp_min(lengths.float(), 1.0)[:, None]
    est = est * mask
    target = target * mask
    if zero_mean:
        est = (est - est.sum(-1, keepdim=True) / n) * mask
        target = (target - target.sum(-1, keepdim=True) / n) * mask
    alpha = ((est * target).sum(-1, keepdim=True) + _EPS) / (
        (target * target).sum(-1, keepdim=True) + _EPS)
    s_target = alpha * target
    noise = (est - s_target) * mask
    ratio = ((s_target ** 2).sum(-1) + _EPS) / ((noise ** 2).sum(-1) + _EPS)
    return 10.0 * torch.log10(ratio)


# ---------------------------------------------------------------------------
# Codebook statistics (accumulators)
# ---------------------------------------------------------------------------

def codebook_histogram(indices, codebook_size: int):
    """Count of each code, (codebook_size,) fp32, summable across steps."""
    return torch.bincount(indices.reshape(-1).long(), minlength=codebook_size).float()


def perplexity_from_histogram(hist):
    """exp(entropy) of the empirical code distribution (0 for an empty one)."""
    hist = hist.float()
    total = hist.sum()
    probs = hist / torch.clamp_min(total, 1.0)
    ent = -torch.where(probs > 0, probs * torch.log(probs), torch.zeros_like(probs)).sum()
    return torch.where(total > 0, torch.exp(ent), torch.zeros_like(ent))


def utilization_from_histogram(hist):
    """The share of codes used at least once."""
    return (hist > 0).float().mean()


# ---------------------------------------------------------------------------
# STOI (host metric, numpy)
# ---------------------------------------------------------------------------

_STOI_FS = 10000
_STOI_NFFT = 512
_STOI_WIN = 256
_STOI_HOP = 128
_STOI_NBANDS = 15
_STOI_MINFREQ = 150.0
_STOI_N = 30          # segment length (frames)
_STOI_BETA = -15.0    # clipping SDR bound (dB)
_STOI_DYN_RANGE = 40.0
# pystoi's guard in every division and log: machine epsilon, not 1e-8
_STOI_EPS = np.finfo(np.float64).eps


def _thirdoct(fs, nfft, num_bands, min_freq):
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands)
    cf = 2.0 ** (k / 3.0) * min_freq
    flo = cf * 2 ** (-1.0 / 6)
    fhi = cf * 2 ** (1.0 / 6)
    A = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        lo = np.argmin((f - flo[i]) ** 2)
        hi = np.argmin((f - fhi[i]) ** 2)
        A[i, lo:hi] = 1.0
    return A


def _stoi_frames(x):
    """Hann-windowed frames with pystoi's exclusive framing: both its
    ``utils.stft`` and ``remove_silent_frames`` iterate
    range(0, len(x) - win, hop), skipping a last frame that fits exactly."""
    w = np.hanning(_STOI_WIN + 2)[1:-1]
    n = max(-(-(len(x) - _STOI_WIN) // _STOI_HOP), 0)
    idx = np.arange(n)[:, None] * _STOI_HOP + np.arange(_STOI_WIN)[None, :]
    return x[idx] * w


def _remove_silent_frames(x, y):
    """pystoi's remove_silent_frames: drop frames whose windowed energy is
    more than 40 dB below the loudest, overlap-add the rest back."""
    xf = _stoi_frames(x)
    yf = _stoi_frames(y)
    if len(xf) == 0:
        return None, None
    energies = 20 * np.log10(np.linalg.norm(xf, axis=1) + _STOI_EPS)
    mask = (np.max(energies) - _STOI_DYN_RANGE - energies) < 0
    xf, yf = xf[mask], yf[mask]
    if len(xf) == 0:
        return None, None

    def ola(frames):
        out = np.zeros((len(frames) - 1) * _STOI_HOP + _STOI_WIN)
        for i, fr in enumerate(frames):
            out[i * _STOI_HOP:i * _STOI_HOP + _STOI_WIN] += fr
        return out

    return ola(xf), ola(yf)


def stoi(target: np.ndarray, est: np.ndarray, fs: int = 16000) -> float:
    """Short-Time Objective Intelligibility (classic, non-extended), as
    pystoi computes it: 10 kHz operating rate, silent-frame removal (40 dB,
    Hann 256/128), 15 third-octave bands from 150 Hz over a 512-point FFT,
    30-frame segments with a clipped (-15 dB SDR bound) normalised
    correlation, averaged over bands and segments. NaN where the signal is
    too short or silent. target/est: 1-D waveforms at fs."""
    from ..ops.resample import resample

    x = np.asarray(target, np.float64).ravel()
    y = np.asarray(est, np.float64).ravel()
    if fs != _STOI_FS:
        x = resample(torch.from_numpy(x.astype(np.float32)), fs, _STOI_FS).numpy().astype(np.float64)
        y = resample(torch.from_numpy(y.astype(np.float32)), fs, _STOI_FS).numpy().astype(np.float64)
    x, y = _remove_silent_frames(x, y)
    if x is None or len(x) < _STOI_WIN:
        return float("nan")

    def spectrogram(sig):
        frames = _stoi_frames(sig)
        return np.abs(np.fft.rfft(frames, _STOI_NFFT, axis=1)) ** 2  # (M, F)

    A = _thirdoct(_STOI_FS, _STOI_NFFT, _STOI_NBANDS, _STOI_MINFREQ)
    X = np.sqrt(spectrogram(x) @ A.T)  # (M, J)
    Y = np.sqrt(spectrogram(y) @ A.T)
    M = X.shape[0]
    if M < _STOI_N:
        return float("nan")
    c = 10 ** (-_STOI_BETA / 20.0)
    scores = []
    for m in range(_STOI_N, M + 1):
        Xseg = X[m - _STOI_N:m]  # (N, J)
        Yseg = Y[m - _STOI_N:m]
        # norm-ratio normalisation, clip at x·(1 + c), then mean-centre and
        # unit-normalise each vector (each norm with its own eps)
        alpha = (np.linalg.norm(Xseg, axis=0)
                 / (np.linalg.norm(Yseg, axis=0) + _STOI_EPS))
        Yprime = np.minimum(Yseg * alpha[None, :], Xseg * (1 + c))
        xn = Xseg - np.mean(Xseg, axis=0, keepdims=True)
        yn = Yprime - np.mean(Yprime, axis=0, keepdims=True)
        xn = xn / (np.linalg.norm(xn, axis=0, keepdims=True) + _STOI_EPS)
        yn = yn / (np.linalg.norm(yn, axis=0, keepdims=True) + _STOI_EPS)
        scores.append(np.mean(np.sum(xn * yn, axis=0)))
    return float(np.mean(scores))


# ---------------------------------------------------------------------------
# PESQ (host metric)
# ---------------------------------------------------------------------------

def pesq_impl() -> str:
    """Which implementation ``pesq_metric`` runs here: 'itu_package' (the ITU
    ``pesq`` package, preferred when importable) or 'native_p862'
    (``train/pesq_p862.py``). Logged beside every PESQ value."""
    try:
        import pesq  # noqa: F401

        return "itu_package"
    except ImportError:
        return "native_p862"


def pesq_metric(target: np.ndarray, est: np.ndarray, fs: int = 16000,
                mode: str = "wb") -> Optional[float]:
    """PESQ MOS-LQO: the ITU ``pesq`` package when importable, else the
    in-repo P.862 pipeline. None only for degenerate inputs (too short,
    silent), as the reference's soft PESQ error handling."""
    t = np.asarray(target, np.float32).ravel()
    e = np.asarray(est, np.float32).ravel()
    try:
        from pesq import pesq as _pesq
    except ImportError:
        _pesq = None
    if _pesq is not None:
        try:
            return float(_pesq(fs, t, e, mode))
        except Exception:  # the package raises on degenerate input; reported as no value
            return None
    from .pesq_p862 import pesq_p862

    v = pesq_p862(t, e, fs=fs, mode=mode)
    return None if math.isnan(v) else float(v)
