"""The devices a parallel path runs on (counterpart of ``make_data_mesh`` in
``audiotokenization_tpu/parallel/mesh.py``).

The JAX package drives its parallel paths from one controller over a
``Mesh`` of the devices one process sees. The port's counterpart is one
process with an explicit list of ``torch.device``s: each shard's work is
queued on its own device, and the exchanges between neighbours are tensor
copies between devices (P2P over NVLink on a host with several cards). A
device may appear more than once in a list: ``[cuda:0] * 4`` runs four
shards on one card, and ``[cpu] * 4`` four on the CPU, as the tests do.

``visible_devices`` is the one place that enumerates the cards; the CLIs
take every visible card from it, and a test may patch it to list the CPU
n times, as the JAX tests run on 8 virtual CPU devices.

Training runs one process per rank instead (``torch.distributed``, launched
by ``torchrun``): ``initialize_distributed`` reads torchrun's environment
and makes the process group, ``process_index`` / ``process_count`` stripe
the loaders, ``local_device`` is the rank's card, and ``fsdp_sharding_for``
is the FSDP placement rule (``parallel/fsdp.py``). A CUDA run takes NCCL,
a CPU run gloo; ``backend="gloo"`` on CUDA tensors lets several ranks share
one card, which NCCL refuses.
"""
from __future__ import annotations

import copy
import os
from typing import Optional

import torch
import torch.distributed as dist


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def initialize_distributed(device="cuda", *, backend: Optional[str] = None):
    """The process group of a ``torchrun`` launch, from its ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``: NCCL for
    ``device="cuda"`` (the rank's card made current), gloo for the CPU, or
    ``backend`` as given. With ``WORLD_SIZE`` 1 or unset it does nothing
    and returns None; a failed ``init_process_group`` raises."""
    world = _env_int("WORLD_SIZE", 1)
    if world <= 1:
        return None
    device = local_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        addr = os.environ.get("MASTER_ADDR", "localhost")
        port = os.environ.get("MASTER_PORT", "29500")
        dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                                rank=_env_int("RANK", 0), world_size=world)
    return dist.group.WORLD


def process_group():
    """The training's group: None in one process; the world group once
    ``initialize_distributed`` (or the caller) made one. A ``WORLD_SIZE``
    above 1 with no group raises: a rank never trains alone by mistake."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist.group.WORLD
    if _env_int("WORLD_SIZE", 1) > 1:
        raise RuntimeError(f"WORLD_SIZE is {os.environ['WORLD_SIZE']} but no process group "
                           "exists: call parallel.mesh.initialize_distributed() first")
    return None


def process_index(group=None) -> int:
    """This process's rank (0 without a group)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(group)
    return 0


def process_count(group=None) -> int:
    """The number of ranks (1 without a group)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group)
    return 1


def local_device(device="cuda") -> torch.device:
    """The rank's device: the CPU for ``device="cpu"``, else
    ``cuda:LOCAL_RANK`` (ranks past the card count share the cards in turn,
    which only gloo allows). An explicit index is kept. Raises without a
    card."""
    device = torch.device(device)
    if device.type == "cpu":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run the "
                           "plain PyTorch versions of the kernels")
    if device.index is not None:
        return device
    return torch.device("cuda", _env_int("LOCAL_RANK", 0) % torch.cuda.device_count())


def shard_batch(batch: dict, group=None) -> dict:
    """This rank's rows of a global batch (JAX ``shard_batch`` over the data
    axis): rank r of n takes rows [r·B/n, (r+1)·B/n) of every key, so rank
    0's rows come first in the global order. The loaders stripe files
    instead; this serves a caller that holds the whole batch."""
    n, r = process_count(group), process_index(group)
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch dim {v.shape[0]} of {k!r} not divisible by {n} ranks")
        m = v.shape[0] // n
        out[k] = v[r * m:(r + 1) * m]
    return out


def fsdp_sharding_for(shape, n: int, *, min_size: int = 2 ** 14) -> Optional[int]:
    """The FSDP placement rule for one leaf over ``n`` ranks (JAX
    ``parallel/mesh.py::fsdp_sharding_for``): the first axis that ``n``
    divides, for a leaf of at least ``min_size`` elements; None (replicated)
    for a smaller or indivisible one."""
    shape = tuple(shape)
    size = 1
    for d in shape:
        size *= int(d)
    if shape and size >= min_size:
        for i, d in enumerate(shape):
            if d % n == 0 and d >= n:
                return i
    return None


def visible_devices(device="cuda") -> list:
    """Every CUDA device this process sees (raises without one), or
    ``[cpu]`` for ``device="cpu"``."""
    device = torch.device(device)
    if device.type == "cpu":
        return [device]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run the "
                           "plain PyTorch versions of the kernels")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def data_devices(devices=None, *, device="cuda") -> list:
    """The shards' devices: ``devices`` as given (repeats allowed), else
    every visible card (``visible_devices``), or ``[cpu]`` for
    ``device="cpu"``. A CUDA device in the list raises without a card."""
    if devices is None:
        return visible_devices(device)
    out = [torch.device(d) for d in devices]
    if not out:
        raise ValueError("data_devices: the device list is empty")
    if any(d.type == "cuda" for d in out) and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass CPU devices to run the plain "
                           "PyTorch versions of the kernels")
    return out


def _key(device: torch.device):
    """A device with an index, so that ``cuda`` and ``cuda:0`` are one key."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def module_device(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


class Replicas:
    """One copy of a module per distinct device of a list: the module
    itself on its own device, a deep copy moved to each other one. ``[cuda:0]
    * 4`` thus holds one copy. The copies are made once and kept while the
    source is the same object (held here, so that its id is never a
    recycled one)."""

    def __init__(self):
        self._src = None
        self._copies: dict = {}

    def __call__(self, module: torch.nn.Module, device) -> torch.nn.Module:
        if self._src is not module:
            self._src, self._copies = module, {}
        device = _key(torch.device(device))
        if device == _key(module_device(module)):
            return module
        if device not in self._copies:
            self._copies[device] = copy.deepcopy(module).to(device)
        return self._copies[device]
