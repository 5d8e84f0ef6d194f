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

``initialize_distributed``, ``shard_batch`` and the FSDP rules belong to
training (``torch.distributed``, multi-process by nature) and are not here.
"""
from __future__ import annotations

import copy

import torch


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
