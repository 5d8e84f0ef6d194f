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

The semantic branch's items: ``semantic_dir`` attaches each file's
precomputed teacher output (``<stem>.npy``, float16 (1024, Tf), written by
``cli/precompute_semantic.py``), sliced at the crop's frame offset, the
crop's start then a multiple of the hop so that the frames align exactly;
``compute_feats`` attaches the teacher's input features of the cropped
clip (``ops/fbank.py::w2v_bert_features_from_clip``). Both are zero-padded
to the batch's longest in the collate, as ``feats`` (B, Tf', 160) and
``semantic_target`` (B, 1024, Tf).

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
              rng: Optional[np.random.RandomState] = None, return_start: bool = False,
              crop_multiple: int = 1):
    """Load one file and apply the crop/pad policy. Returns float32 (T,)
    [, the crop's start sample with ``return_start``]. ``crop_multiple``:
    random crops start at multiples of it (the hop, for precomputed
    per-frame targets)."""
    wav, sr = read_audio(path)
    wav = wav[0]  # channel 0
    if sr != sample_rate:
        from ..ops.resample import resample

        wav = resample(torch.from_numpy(wav), sr, sample_rate).numpy()
    start = 0
    if min_audio_length != -1:
        if len(wav) < min_audio_length:
            wav = np.pad(wav, (0, min_audio_length - len(wav)))
        if train:
            hi = (len(wav) - min_audio_length) // crop_multiple + 1
            start = int((rng or np.random).randint(0, hi)) * crop_multiple
        wav = wav[start:start + min_audio_length]
    if pad_to_multiple_of and len(wav) % pad_to_multiple_of != 0:
        wav = np.pad(wav, (0, pad_to_multiple_of - len(wav) % pad_to_multiple_of))
    wav = wav.astype(np.float32)
    return (wav, start) if return_start else wav


class AudioDataset:
    """Map-style dataset over a filelist. An item is the clip (T,), or with
    ``semantic_dir`` or ``compute_feats`` a dict {"wav", "semantic_target"
    (1024, T / hop_length) float32, "feats" (Tf', 160)} (module
    docstring)."""

    def __init__(self, split: DatasetSplit, *, sample_rate: int,
                 pad_to_multiple_of: int, root: Optional[str] = None,
                 train: bool = False, semantic_dir: Optional[str] = None,
                 hop_length: int = 200, compute_feats: bool = False):
        self.files = read_filelist(split.filelist, root)
        self.split = split
        self.sample_rate = sample_rate
        self.pad_to_multiple_of = pad_to_multiple_of
        self.train = train
        self.semantic_dir = Path(semantic_dir) if semantic_dir else None
        self.hop_length = hop_length
        self.compute_feats = compute_feats

    def __len__(self):
        return len(self.files)

    def get(self, idx: int, rng=None):
        wav, start = load_clip(
            self.files[idx], sample_rate=self.sample_rate,
            min_audio_length=self.split.min_audio_length,
            pad_to_multiple_of=self.pad_to_multiple_of, train=self.train, rng=rng,
            return_start=True, crop_multiple=self.hop_length if self.semantic_dir else 1)
        if self.semantic_dir is None and not self.compute_feats:
            return wav
        item = {"wav": wav}
        if self.compute_feats:
            from ..ops.fbank import w2v_bert_features_from_clip

            item["feats"] = w2v_bert_features_from_clip(wav)
        if self.semantic_dir is not None:
            sem = np.load(self.semantic_dir / (Path(self.files[idx]).stem + ".npy"))
            f0, tf = start // self.hop_length, len(wav) // self.hop_length
            sem = sem[:, f0:f0 + tf]
            if sem.shape[1] < tf:
                sem = np.pad(sem, ((0, 0), (0, tf - sem.shape[1])))
            item["semantic_target"] = sem.astype(np.float32)
        return item


def _stack_padded(arrays, *, axis: int) -> torch.Tensor:
    """float32 arrays of one shape but ``axis`` -> one tensor, each zero-padded
    along ``axis`` to the longest."""
    n = max(a.shape[axis] for a in arrays)
    shape = list(arrays[0].shape)
    shape[axis] = n
    out = torch.zeros((len(arrays), *shape), dtype=torch.float32)
    for j, a in enumerate(arrays):
        out[j].narrow(axis, 0, a.shape[axis]).copy_(torch.from_numpy(np.asarray(a, np.float32)))
    return out


class DataLoader:
    """Batched, prefetching iterator with deterministic epoch shuffling.

    Over several processes (``process_index`` of ``process_count``, the
    ranks of a data-parallel run) each takes the stripe i::N of the
    shuffled file list, the permutation the same on every rank (seeded by
    ``seed`` and the epoch). The list is first padded by repeating its
    head until N divides it, as torch's ``DistributedSampler`` and the JAX
    loader do, so that every rank yields the same number of batches:
    unequal stripes would leave a rank waiting in a collective its peers
    never reach."""

    def __init__(self, dataset: AudioDataset, *, batch_size: int,
                 shuffle: bool = False, seed: int = 0, num_workers: int = 8,
                 drop_last: bool = True, prefetch: int = 4, pin_memory: bool = False,
                 process_index: int = 0, process_count: int = 1):
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} outside [0, {process_count})")
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.pin_memory = pin_memory
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        if self.process_count > 1 and len(idx):
            idx = np.resize(idx, -(-len(idx) // self.process_count) * self.process_count)
        return idx[self.process_index::self.process_count]

    def __len__(self):
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _item_seeds(self, indices: np.ndarray) -> dict:
        """Each item's crop seed for this epoch, as the JAX loader draws them
        (a str seed is mixed through crc32, independent of PYTHONHASHSEED)."""
        ent = (self.seed if isinstance(self.seed, (int, np.integer))
               else zlib.crc32(str(self.seed).encode()))
        mix = np.random.SeedSequence([int(ent) & 0xFFFFFFFF, self.epoch])
        rng = np.random.RandomState(mix.generate_state(1)[0] % (2 ** 31))
        return dict(zip(indices.tolist(), rng.randint(0, 2 ** 31, size=len(indices)).tolist()))

    def _collate(self, items) -> dict:
        """Items (clips, or dicts of them) -> the batch, each key zero-padded
        to its longest along its frame axis."""
        if not isinstance(items[0], dict):
            items = [{"wav": c} for c in items]
        clips = [it["wav"] for it in items]
        batch = {"wav": _stack_padded(clips, axis=0),
                 "lengths": torch.tensor([len(c) for c in clips], dtype=torch.int32)}
        if "feats" in items[0]:
            batch["feats"] = _stack_padded([it["feats"] for it in items], axis=0)
        if "semantic_target" in items[0]:
            batch["semantic_target"] = _stack_padded([it["semantic_target"] for it in items],
                                                     axis=1)
        if self.pin_memory:
            batch = {k: v.pin_memory() for k, v in batch.items()}
        return batch

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
