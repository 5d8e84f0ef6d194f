"""The one traffic generator: it reads a mix's data file
(``traffic/<mix>.json``) and makes, from the seed, a pool of utterances and
the endless stream of batches the entry drives.

The pool's lengths are the same set for every seed: bucket k (seconds)
with n batches holds n x batch_size utterances whose lengths are spread
evenly over ((k - 1) s, k s], rounded up to a whole hop. The seed decides
which utterances share a batch, the order of the batches in each pass over
the pool, and the audio: int16 PCM made on the device in one pass, a tone
of a few hundred Hz under a syllable-rate envelope over noise, and kept on
the host as the command-line extractor holds what it read. Every pass
covers the pool once, each bucket in full batches, as the extractor
flushes a bucket when it fills.
"""
from __future__ import annotations

import math

import numpy as np
import torch


class Pool:
    """Utterances of a mix: ``lengths`` (samples), ``bucket`` (samples a
    batch is padded to), and ``pcm(i)`` the int16 samples of utterance i."""

    def __init__(self, mix: dict, seed: int, device, *, hop: int):
        sr = int(mix["sample_rate"])
        quantum = int(round(mix["quantum_s"] * sr))
        self.batch_size = int(mix["batch_size"])
        self.sample_rate = sr
        lengths, buckets = [], []
        for sec, n_batches in sorted(mix["buckets"].items(), key=lambda kv: float(kv[0])):
            top = int(round(float(sec) * sr))
            count = int(n_batches) * self.batch_size
            for i in range(count):
                t = top - quantum + (i + 0.5) / count * quantum
                lengths.append(min(top, int(math.ceil(t / hop)) * hop))
                buckets.append(top)
        self.lengths = np.asarray(lengths, np.int64)
        self.bucket = np.asarray(buckets, np.int64)
        self.seed = int(seed)
        self._rng = np.random.default_rng([self.seed % (2 ** 63), 7])
        self._starts = np.concatenate([[0], np.cumsum(self.lengths)])
        self._data = _make_pcm(self.lengths, self.seed, sr, device)

    def pcm(self, i: int) -> np.ndarray:
        return self._data[self._starts[i]:self._starts[i + 1]]

    def passes(self):
        """Batches forever: lists of utterance indices, each of one bucket,
        in a new seeded order every pass."""
        while True:
            batches = []
            for top in np.unique(self.bucket):
                ids = np.flatnonzero(self.bucket == top)
                ids = ids[self._rng.permutation(len(ids))]
                batches += [ids[j:j + self.batch_size].tolist()
                            for j in range(0, len(ids), self.batch_size)]
            for j in self._rng.permutation(len(batches)):
                yield batches[j]


def _make_pcm(lengths, seed: int, sr: int, device) -> np.ndarray:
    """int16 audio for every utterance, concatenated, made on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 2654435761 + 12345) % (2 ** 63))
    n = int(lengths.sum())
    k = len(lengths)
    with torch.no_grad():
        per = torch.rand(k, 4, generator=gen, device=device)
        f0 = 90.0 + 210.0 * per[:, 0]            # Hz
        rate = 2.0 + 4.0 * per[:, 1]             # syllables a second
        gain = 0.05 + 0.25 * per[:, 2]
        phase = 6.2831853 * per[:, 3]
        owner = torch.repeat_interleave(torch.arange(k, device=device),
                                        torch.as_tensor(lengths, device=device))
        starts = torch.as_tensor(np.concatenate([[0], np.cumsum(lengths)[:-1]]), device=device)
        t = (torch.arange(n, device=device) - starts[owner]).float() / sr
        env = torch.sin(3.14159265 * rate[owner] * t + phase[owner]).abs()
        tone = torch.sin(6.2831853 * f0[owner] * t) + 0.5 * torch.sin(12.5663706 * f0[owner] * t)
        x = gain[owner] * (env * tone + 0.3 * torch.randn(n, generator=gen, device=device))
        pcm = torch.clamp(torch.round(x * 32767.0), -32768, 32767).to(torch.int16)
        del owner, t, env, tone, x
        return pcm.cpu().numpy()
