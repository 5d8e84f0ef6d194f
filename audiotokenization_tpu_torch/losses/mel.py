"""Multi-resolution mel-spectrogram loss (counterpart of
``audiotokenization_tpu/losses/mel.py``): 7 resolutions, window 32..2048,
hop = window / 4, n_mels 5..320, magnitude mels with slaney norm and scale,
L1 between log10(clamp(mel, 1e-5)) of the generated and the target
waveform, summed over resolutions. fp32 throughout.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..ops.stft import hann_window, mel_filterbank, power, stft


class MultiResolutionMelLoss:
    def __init__(self, sample_rate: int = 16000,
                 n_mels: Sequence[int] = (5, 10, 20, 40, 80, 160, 320),
                 window_lengths: Sequence[int] = (32, 64, 128, 256, 512, 1024, 2048),
                 clamp_eps: float = 1e-5):
        self.resolutions = [
            (wl, wl // 4, torch.from_numpy(mel_filterbank(sample_rate=sample_rate,
                                                          n_fft=wl, n_mels=nm)))
            for nm, wl in zip(n_mels, window_lengths)]
        self.clamp_eps = clamp_eps
        self._fbs: dict[torch.device, list[torch.Tensor]] = {}

    def __call__(self, x, y):
        """x, y: (B, T) waveforms -> scalar loss."""
        fbs = self._fbs.get(x.device)
        if fbs is None:  # copied to a device once
            fbs = self._fbs[x.device] = [fb.to(x.device) for _, _, fb in self.resolutions]
        loss = 0.0
        for (wl, hop, _), fb in zip(self.resolutions, fbs):
            loss = loss + torch.mean(torch.abs(self._log_mel(x, wl, hop, fb)
                                               - self._log_mel(y, wl, hop, fb)))
        return loss

    def _log_mel(self, x, n_fft, hop, fb):
        s = stft(x, n_fft=n_fft, hop_length=hop, window=hann_window(n_fft, device=x.device))
        # sqrt of the power kept off exact 0: sqrt's gradient there is 0/0 = NaN
        # (torch.abs of a complex tensor differs from this at 0 under autograd)
        mag = torch.sqrt(torch.clamp_min(power(s), 1e-20))
        mel = torch.einsum("mf,bft->bmt", fb, mag)
        return torch.log10(torch.clamp_min(mel, self.clamp_eps))
