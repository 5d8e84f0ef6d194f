"""Running a module's functions on other tensors than its parameters.

The port's models are ``nn.Module`` parameter containers read by plain
functions (``bigcodec_encode(p, x)``). Mixed precision runs those functions
on bf16 copies of the fp32 masters, and ``parameters_as`` puts the copies in
place for the body (as ``torch.func.functional_call`` does, for a function
rather than a ``forward``). ``checkpointed`` is ``torch.utils.checkpoint``
for such a function: the tensors substituted for the module's parameters
(the bf16 copies) are inputs of the checkpoint, so the recompute in the
backward runs on the same tensors after the substitution has ended.

A parameter whose weight is not in it between uses (an FSDP block's leaf,
whose cuts are gathered at the block, or a tensor-parallel leaf, held as
cuts on the model devices; ``parallel/fsdp.py``) is marked ``deferred``:
``cast_parameters`` leaves it out and records the cast, which the code that
puts the weight in place applies (``deferred_cast``) for the body of
``parameters_as``.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Mapping

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint


_local = threading.local()


class Casts(dict):
    """``cast_parameters``' result: name -> copy, and ``deferred``, the
    casts of the deferred parameters left out: {id: (param, dtype, detach)}."""

    deferred: dict = {}


def deferred_cast(param: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``weight`` (the value of the deferred ``param``, or a cut of it) as
    the innermost ``parameters_as`` over a ``cast_parameters`` result casts
    ``param``: detached and in its dtype; ``weight`` itself outside one."""
    for casts in reversed(getattr(_local, "casts", ())):
        hit = casts.get(id(param))
        if hit is not None:
            _, dtype, detach = hit
            return (weight.detach() if detach else weight).to(dtype)
    return weight


@contextlib.contextmanager
def parameters_as(module: nn.Module, tensors: Mapping[str, torch.Tensor]):
    """Within the body, each parameter of ``module`` named in ``tensors``
    (a ``named_parameters`` path) is that tensor; restored after; and the
    deferred casts of a ``Casts`` hold (``deferred_cast``). An ``nn.LSTM``
    re-reads its weights at every forward."""
    swapped = []
    stack = _local.__dict__.setdefault("casts", [])
    stack.append(getattr(tensors, "deferred", {}))
    try:
        for name, t in tensors.items():
            owner, _, leaf = name.rpartition(".")
            m = module.get_submodule(owner)
            swapped.append((m, leaf, m._parameters[leaf]))
            m._parameters[leaf] = t
        yield
    finally:
        for m, leaf, orig in reversed(swapped):
            m._parameters[leaf] = orig
        stack.pop()


def cast_parameters(module: nn.Module, dtype: torch.dtype, *, skip: str | None = None,
                    detach: bool = False) -> dict[str, torch.Tensor]:
    """Differentiable ``dtype`` copies of the parameters of ``module``
    (detached ones with ``detach``), leaving out the subtree ``skip``;
    gradients reach the masters through the casts. A deferred parameter's
    cast is recorded instead (module docstring)."""
    out = Casts()
    out.deferred = {}
    for name, p in module.named_parameters():
        if skip is not None and name.startswith(skip + "."):
            continue
        if getattr(p, "deferred", False):
            out.deferred[id(p)] = (p, dtype, detach)
        else:
            out[name] = (p.detach() if detach else p).to(dtype)
    return out


def checkpointed(fn, module: nn.Module, x, **kwargs):
    """``fn(x, module, **kwargs)``, its activations recomputed in the
    backward rather than kept (``torch.utils.checkpoint``, non-reentrant).
    The recompute runs in the forward's context, which a backward on
    autograd's own thread would not see otherwise: its deferred casts and
    its tensor-parallel context (``parallel/tp.py``)."""
    from ..parallel import tp

    # the substitutes in place (casts, detached copies) are the checkpoint's
    # inputs; the module's own parameters are read from it in the recompute
    # as in the forward: a TP leaf is found by its identity (parallel/tp.py),
    # which a saved input loses under an FSDP block's saved-tensor hooks
    named = [(n, t) for n, t in module.named_parameters() if not isinstance(t, nn.Parameter)]
    casts = list(getattr(_local, "casts", ()))  # the deferred casts, for the recompute
    tp_ctx = tp.current_context()

    def run(x, *ts):
        outer = _local.__dict__.get("casts", [])
        _local.casts = casts + []
        try:
            with tp.tp_shard_activations(tp_ctx), \
                    parameters_as(module, {n: t for (n, _), t in zip(named, ts)}):
                return fn(x, module, **kwargs)
        finally:
            _local.casts = outer

    return checkpoint(run, x, *(t for _, t in named), use_reentrant=False)
