"""Running a module's functions on other tensors than its parameters.

The port's models are ``nn.Module`` parameter containers read by plain
functions (``bigcodec_encode(p, x)``). Mixed precision runs those functions
on bf16 copies of the fp32 masters, and ``parameters_as`` puts the copies in
place for the body (as ``torch.func.functional_call`` does, for a function
rather than a ``forward``). ``checkpointed`` is ``torch.utils.checkpoint``
for such a function: the module's current tensors are inputs of the
checkpoint, so the recompute in the backward runs on the same tensors, the
bf16 copies included, after the substitution has ended.
"""
from __future__ import annotations

import contextlib
from typing import Mapping

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint


@contextlib.contextmanager
def parameters_as(module: nn.Module, tensors: Mapping[str, torch.Tensor]):
    """Within the body, each parameter of ``module`` named in ``tensors``
    (a ``named_parameters`` path) is that tensor; restored after. An
    ``nn.LSTM`` re-reads its weights at every forward."""
    swapped = []
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


def cast_parameters(module: nn.Module, dtype: torch.dtype, *, skip: str | None = None,
                    detach: bool = False) -> dict[str, torch.Tensor]:
    """Differentiable ``dtype`` copies of the parameters of ``module``
    (detached ones with ``detach``), leaving out the subtree ``skip``;
    gradients reach the masters through the casts."""
    return {name: (p.detach() if detach else p).to(dtype)
            for name, p in module.named_parameters()
            if skip is None or not name.startswith(skip + ".")}


def checkpointed(fn, module: nn.Module, x, **kwargs):
    """``fn(x, module, **kwargs)``, its activations recomputed in the
    backward rather than kept (``torch.utils.checkpoint``, non-reentrant)."""
    named = list(module.named_parameters())

    def run(x, *ts):
        with parameters_as(module, {n: t for (n, _), t in zip(named, ts)}):
            return fn(x, module, **kwargs)

    return checkpoint(run, x, *(t for _, t in named), use_reentrant=False)
