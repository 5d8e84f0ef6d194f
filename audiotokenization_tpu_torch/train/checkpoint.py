"""Checkpoints of the train state and the run dir's config (counterpart of
``audiotokenization_tpu/train/checkpoint.py``, in this package's own
format).

The run-dir layout is the JAX package's: ``config.json``; ``ckpt/<step>/``,
the rolling window (``max_to_keep`` newest); ``ckpt_best/<step>/``, one deep,
the step with the lowest monitored metric (``mel_loss``), with ``best.json``
naming it. Each step dir holds ``state.pt``, ``torch.save`` of
``TrainState.state_dict()``, in the one-card layout whatever the world
size (rank 0 writes it, after FSDP gathers the cuts), so a run restores on
any number of ranks, each reading the file (a run dir every rank sees). A
save is written into a temporary dir, synced to disk and renamed, so a
crash never leaves a half checkpoint.

Saving is asynchronous. On the caller's thread, ``save`` copies the state
into pinned host buffers (reused from save to save) with copies queued on
the current stream: the next step's in-place optimizer updates queue behind
them, so the copy holds this step's values without a host sync. A
background thread waits for the copies and writes the file; ``wait`` joins
it, and the next ``save`` waits for the previous write before reusing the
buffers.

An inference run dir holds in ``state.pt`` the generator's weights alone
(``{"step", "gen"}``): ``load_checkpoint_params`` reads it, a resume
refuses it. ``scripts/jax_run_to_torch.py`` writes one from a JAX (Orbax)
run dir; this package itself never reads Orbax.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Optional

import torch

from ..config import Config, load_config, save_config
from ..models.codec import Codec, resolve_device
from .state import TrainState

STATE_FILE = "state.pt"


def _steps(directory: Path) -> list[int]:
    """The saved steps under ``directory`` (temporary dirs excluded)."""
    if not directory.is_dir():
        return []
    return sorted(int(p.name) for p in directory.iterdir() if p.name.isdigit())


def _write_step(directory: Path, step: int, write):
    """``write(path)`` into a temporary dir, then rename it to ``<step>``."""
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f".{step}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    write(tmp / STATE_FILE)
    final = directory / str(step)
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)


def _save_file(obj, path: Path):
    with open(path, "wb") as f:
        torch.save(obj, f)
        f.flush()
        os.fsync(f.fileno())


def _load_file(path: Path, *, mmap: bool = False):
    return torch.load(path, map_location="cpu", weights_only=True, mmap=mmap)


def save_state(directory, step: int, obj, *, max_to_keep: int):
    """Write ``obj`` as ``<directory>/ckpt/<step>/state.pt`` through a
    temporary dir, synced and renamed, and keep the ``max_to_keep`` newest
    steps: the rolling window, written on the caller's thread."""
    ckpt = Path(directory).resolve() / "ckpt"
    _write_step(ckpt, step, lambda p: _save_file(obj, p))
    for old in _steps(ckpt)[:-max_to_keep]:
        shutil.rmtree(ckpt / str(old))


def load_latest(directory) -> dict:
    """The newest ``ckpt/<step>/state.pt`` of a run dir, on the CPU; raises
    FileNotFoundError without one."""
    ckpt = Path(directory).resolve() / "ckpt"
    steps = _steps(ckpt)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    return _load_file(ckpt / str(steps[-1]) / STATE_FILE)


def _load_train_state(state: TrainState, path: Path):
    """Load a full train state's file into ``state``; a generator-only file
    (an inference run dir) raises."""
    sd = _load_file(path)
    if "disc" not in sd or "gen_opt" not in sd:
        raise ValueError(
            f"{path} holds only the generator's weights (an inference run dir, such as "
            "scripts/jax_run_to_torch.py writes): it serves extraction and evaluation, "
            "but training cannot resume from it")
    state.load_state_dict(sd)


class CheckpointManager:
    """The run dir's checkpoints (module docstring). Over the ranks of
    ``group`` every rank calls ``save`` and ``wait`` (under FSDP the state
    dict gathers the cuts, a collective), rank 0 alone writes, and ``wait``
    is where the others wait for its write: a barrier that also carries a
    failed write's error to every rank."""

    def __init__(self, directory, cfg: Config, *, max_to_keep: int = 3, group=None):
        from ..parallel import dp

        self.directory = Path(directory).resolve()
        self.group = group
        self.rank = dp.rank(group)
        self._copied_from: set = set()  # the cards a save's host copies read from
        if self.rank == 0:
            self.directory.mkdir(parents=True, exist_ok=True)
            save_config(cfg, self.directory / "config.json")
        self.max_to_keep = max_to_keep
        self.best_metric = None
        best_file = self.directory / "best.json"
        if best_file.exists():
            self.best_metric = json.loads(best_file.read_text()).get("metric")
        self._buffers: dict = {}  # pinned host copies of the state's tensors, by path
        self._queued: set = set()  # steps handed to the writer
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_save: Optional[dict] = None  # {"stall_s", "bytes"} of the last save

    def _host_copy(self, tree, path=()):
        """``tree`` with every tensor copied into its host buffer: pinned and
        non-blocking from the card, a plain copy on the CPU."""
        if isinstance(tree, dict):
            return {k: self._host_copy(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [self._host_copy(v, path + (i,)) for i, v in enumerate(tree)]
        if not torch.is_tensor(tree):
            return tree
        if tree.is_cuda:
            self._copied_from.add(tree.device)
        buf = self._buffers.get(path)
        if buf is None or buf.shape != tree.shape or buf.dtype != tree.dtype:
            buf = torch.empty(tree.shape, dtype=tree.dtype, pin_memory=tree.is_cuda)
            self._buffers[path] = buf
        return buf.copy_(tree.detach(), non_blocking=True)

    def save(self, state: TrainState, *, metric: Optional[float] = None) -> bool:
        """Queue a save of ``state`` at its step: into the rolling window
        unless that step is there already, and as the best when ``metric``
        is below the best so far. Returns whether anything was queued."""
        t0 = time.perf_counter()
        step = int(state.step)
        rolling = step not in self._queued and step not in _steps(self.directory / "ckpt")
        best = metric is not None and (self.best_metric is None or metric < self.best_metric)
        if not (rolling or best):
            return False
        self.wait()  # the previous write still reads the buffers
        sd = state.state_dict()  # every rank: FSDP gathers the cuts
        if rolling:
            self._queued.add(step)
        if best:
            self.best_metric = float(metric)
        if self.rank == 0:
            self._copied_from = set()
            host = self._host_copy(sd)
            done = []  # each card's copies (a pipeline's stages may sit on several)
            for dev in self._copied_from:
                with torch.cuda.device(dev):
                    done.append(torch.cuda.Event())
                    done[-1].record()
            self._writer = threading.Thread(target=self._write,
                                            args=(host, done, step, rolling, best),
                                            name="checkpoint-writer", daemon=True)
            self._writer.start()
        del sd
        self.last_save = {"stall_s": time.perf_counter() - t0,
                          "bytes": sum(b.numel() * b.element_size() for b in self._buffers.values())}
        return True

    def _write(self, host, done, step: int, rolling: bool, best: bool):
        try:
            for event in done:
                event.synchronize()
            ckpt, ckpt_best = self.directory / "ckpt", self.directory / "ckpt_best"
            if rolling:
                save_state(self.directory, step, host, max_to_keep=self.max_to_keep)
            if best:
                def write_best(p: Path):
                    try:  # the rolling file of the same step, linked rather than written twice
                        os.link(ckpt / str(step) / STATE_FILE, p)
                    except OSError:
                        _save_file(host, p)

                _write_step(ckpt_best, step, write_best)
                for old in _steps(ckpt_best):
                    if old != step:
                        shutil.rmtree(ckpt_best / str(old))
                tmp = self.directory / ".best.json.tmp"
                tmp.write_text(json.dumps({"metric": self.best_metric, "step": step}))
                os.replace(tmp, self.directory / "best.json")
        except BaseException as e:  # re-raised on the caller's thread by wait()
            self._error = e

    def wait(self):
        """Join the write in flight; raise what it raised (on every rank)."""
        from ..parallel import dp

        if self._writer is not None:
            self._writer.join()
            self._writer = None
        err, self._error = self._error, None
        if self.group is not None and not dp.all_agree(err is None, self.group):
            raise RuntimeError("writing a checkpoint failed on rank 0") from err
        if err is not None:
            raise RuntimeError("writing a checkpoint failed") from err

    def latest_step(self) -> Optional[int]:
        steps = _steps(self.directory / "ckpt")
        return steps[-1] if steps else None

    def restore(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        """Load the given (default: latest) step into ``state``, in place."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            return state
        _load_train_state(state, self.directory / "ckpt" / str(step) / STATE_FILE)
        return state


def restore_train_state(directory, state: TrainState, *, best: bool = False,
                        step: Optional[int] = None) -> TrainState:
    """Load a full train state from another run dir into ``state`` (resume
    with the optimizers and the step, possibly into a new run dir): its best
    checkpoint if ``best`` and one was saved, else its latest (or ``step``)."""
    directory = Path(directory).resolve()
    ckpt = directory / "ckpt"
    if best and _steps(directory / "ckpt_best"):
        ckpt = directory / "ckpt_best"
    steps = _steps(ckpt)
    step = step if step is not None else (steps[-1] if steps else None)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    _load_train_state(state, ckpt / str(step) / STATE_FILE)
    return state


def load_checkpoint_params(directory, *, step: Optional[int] = None, best: bool = False,
                           device="cuda"):
    """(cfg, Codec) from a run dir, for inference: the generator of the
    latest (or ``step``'s) checkpoint, or with ``best`` of the best one,
    falling back to the step ``best.json`` names and then to the latest.
    The codec is on ``device`` in eval mode; raises without a card unless
    ``device="cpu"``."""
    device = resolve_device(device)
    directory = Path(directory).resolve()
    cfg = load_config(directory / "config.json")
    ckpt = directory / "ckpt"
    if best:
        if _steps(directory / "ckpt_best"):
            ckpt = directory / "ckpt_best"
        elif (directory / "best.json").exists():
            step = json.loads((directory / "best.json").read_text())["step"]
    steps = _steps(ckpt)
    step = step if step is not None else (steps[-1] if steps else None)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    sd = _load_file(ckpt / str(step) / STATE_FILE, mmap=True)  # reads the generator's part only
    codec = Codec(cfg, generator=torch.Generator().manual_seed(0))
    codec.load_state_dict(sd["gen"])
    return cfg, codec.to(device).eval()
