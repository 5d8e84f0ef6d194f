"""Filelist-driven audio dataset with the reference's crop and pad policy
(counterpart of ``audiotokenization_tpu/data/dataset.py``):

- filelists are text files whose lines are tab-split, first field = path;
  relative paths resolve against a root dir;
- load audio, resample if the file's rate differs from the config's, take
  channel 0;
- if min_audio_length != -1: right-pad short clips to min_audio_length, then
  crop exactly min_audio_length samples, at a random offset when training
  and at 0 for eval;
- zero-pad the tail so that length % pad_to_multiple_of == 0;
- collate into {"wav": (B, T), "lengths": (B,)}.

The loader draws each item's crop from a seed of ``SeedSequence([seed,
epoch])``, as the JAX loader does, so the same filelist, seed and epoch
give the same batches in both packages. Batches are built by a thread pool
ahead of the consumer (``prefetch`` batches) and come out as torch tensors,
in pinned memory when asked, so that the trainer can upload them with
``non_blocking=True``.
"""
from __future__ import annotations

import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch

from ..config import DatasetSplit
from .audio_io import read_audio


def read_filelist(path, root: Optional[str] = None) -> list:
    """Tab-split first field per line; resolve relative paths against root."""
    out = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        p = line.split("\t")[0]
        if root is not None and not Path(p).is_absolute():
            p = str(Path(root) / p)
        out.append(p)
    return out


def load_clip(path, *, sample_rate: int, min_audio_length: int,
              pad_to_multiple_of: int, train: bool,
              rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Load one file and apply the crop/pad policy. Returns float32 (T,)."""
    wav, sr = read_audio(path)
    wav = wav[0]  # channel 0
    if sr != sample_rate:
        from ..ops.resample import resample

        wav = resample(torch.from_numpy(wav), sr, sample_rate).numpy()
    if min_audio_length != -1:
        if len(wav) < min_audio_length:
            wav = np.pad(wav, (0, min_audio_length - len(wav)))
        start = 0
        if train:
            start = int((rng or np.random).randint(0, len(wav) - min_audio_length + 1))
        wav = wav[start:start + min_audio_length]
    if pad_to_multiple_of and len(wav) % pad_to_multiple_of != 0:
        wav = np.pad(wav, (0, pad_to_multiple_of - len(wav) % pad_to_multiple_of))
    return wav.astype(np.float32)


class AudioDataset:
    """Map-style dataset over a filelist. ``semantic_dir`` and
    ``compute_feats`` (the semantic branch's targets and features) are not
    ported and raise."""

    def __init__(self, split: DatasetSplit, *, sample_rate: int,
                 pad_to_multiple_of: int, root: Optional[str] = None,
                 train: bool = False, semantic_dir: Optional[str] = None,
                 compute_feats: bool = False):
        if semantic_dir or compute_feats:
            raise NotImplementedError("the semantic branch's data (semantic_dir, "
                                      "compute_feats) is not ported yet")
        self.files = read_filelist(split.filelist, root)
        self.split = split
        self.sample_rate = sample_rate
        self.pad_to_multiple_of = pad_to_multiple_of
        self.train = train

    def __len__(self):
        return len(self.files)

    def get(self, idx: int, rng=None) -> np.ndarray:
        return load_clip(self.files[idx], sample_rate=self.sample_rate,
                         min_audio_length=self.split.min_audio_length,
                         pad_to_multiple_of=self.pad_to_multiple_of,
                         train=self.train, rng=rng)


class DataLoader:
    """Batched, prefetching iterator with deterministic epoch shuffling; one
    process (the JAX loader's striping across processes is not ported)."""

    def __init__(self, dataset: AudioDataset, *, batch_size: int,
                 shuffle: bool = False, seed: int = 0, num_workers: int = 8,
                 drop_last: bool = True, prefetch: int = 4, pin_memory: bool = False):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.pin_memory = pin_memory
        self.epoch = 0

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        return idx

    def __len__(self):
        n = len(self.ds)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _item_seeds(self, indices: np.ndarray) -> dict:
        """Each item's crop seed for this epoch, as the JAX loader draws them
        (a str seed is mixed through crc32, independent of PYTHONHASHSEED)."""
        ent = (self.seed if isinstance(self.seed, (int, np.integer))
               else zlib.crc32(str(self.seed).encode()))
        mix = np.random.SeedSequence([int(ent) & 0xFFFFFFFF, self.epoch])
        rng = np.random.RandomState(mix.generate_state(1)[0] % (2 ** 31))
        return dict(zip(indices.tolist(), rng.randint(0, 2 ** 31, size=len(indices)).tolist()))

    def _collate(self, clips) -> dict:
        wav = torch.zeros((len(clips), max(len(c) for c in clips)), dtype=torch.float32)
        for j, c in enumerate(clips):
            wav[j, :len(c)] = torch.from_numpy(c)
        lengths = torch.tensor([len(c) for c in clips], dtype=torch.int32)
        if self.pin_memory:
            wav, lengths = wav.pin_memory(), lengths.pin_memory()
        return {"wav": wav, "lengths": lengths}

    def __iter__(self) -> Iterator[dict]:
        indices = self._indices()
        batches = [indices[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(len(self))]
        seed_of = self._item_seeds(indices)

        def load_batch(batch_idx):
            return self._collate([self.ds.get(int(i), np.random.RandomState(seed_of[int(i)]))
                                  for i in batch_idx])

        with ThreadPoolExecutor(self.num_workers) as pool:
            pending = [pool.submit(load_batch, b) for b in batches[:self.prefetch]]
            for nxt in batches[self.prefetch:] + [None] * len(pending):
                fut = pending.pop(0)
                if nxt is not None:
                    pending.append(pool.submit(load_batch, nxt))
                yield fut.result()
        self.epoch += 1
