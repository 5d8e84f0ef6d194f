"""FSDP, ZeRO-3 (counterpart of ``jit_train_step(..., fsdp=True)``, whose
GSPMD shardings ``parallel/mesh.py::fsdp_state_shardings`` places), and
plain data parallelism as its case with no leaf cut.

``ShardedParams`` takes one optimizer's module. Under ``fsdp`` each
parameter that ``mesh.fsdp_sharding_for`` shards (at least ``min_size``
elements, an axis the world size divides) is held at rest as this rank's
equal cut along that axis, and its AdamW moments are the cut's; the rest
stay replicated, as do the module's buffers (the EMA codebook). Between
steps a sharded parameter's full storage is freed. Without ``fsdp``
every leaf is replicated: the gradients are mean-all-reduced and the clip
is the one-process one.

A step gathers each side's full weights at its use (``gathered``: one
all-gather a leaf, the weights contiguous, as K2's ``ResidualUnitFn``
takes them), reduce-scatters each sharded gradient to the mean of this
rank's cut and mean-all-reduces the replicated ones (``reduce``), clips by
the norm over every cut and replicated leaf (``norm``), lets AdamW update
the cuts in place, gathers again where the side is used once more in the
step (``refresh``: the discriminator, whose update the generator's loss
reads), and frees the full weights at the end. The gather is per module,
not per layer: the peak holds one side's full weights and gradients; the
moments and the weights at rest are what is cut by the world size.

The state dict is the one-card one: ``module_state_dict`` and
``full_optim_state`` gather every cut (a collective: every rank calls
them), and the loaders cut a full one back (``load_module_state_dict``,
``local_optim_state``), so a checkpoint moves between world sizes.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch
from torch import nn

from . import dp
from .mesh import fsdp_sharding_for


class _Leaf(NamedTuple):
    name: str
    param: nn.Parameter
    axis: Optional[int]      # None: replicated
    shard: Optional[nn.Parameter]


class ShardedParams:
    """One module's parameters under ZeRO-3 over ``group`` (module
    docstring). ``params`` are what the optimizer updates: each leaf's cut,
    or the parameter itself where it is replicated."""

    def __init__(self, module: nn.Module, group, *, fsdp: bool = True,
                 min_size: int = 2 ** 14):
        self.module = module
        self.group = group
        n, r = dp.world(group), dp.rank(group)
        self.leaves = []
        for name, p in module.named_parameters():
            axis = fsdp_sharding_for(p.shape, n, min_size=min_size) if fsdp else None
            shard = None
            if axis is not None:
                shard = nn.Parameter(p.detach().chunk(n, dim=axis)[r].contiguous().clone())
            self.leaves.append(_Leaf(name, p, axis, shard))
        self.params = [l.param if l.shard is None else l.shard for l in self.leaves]
        if any(l.shard is not None for l in self.leaves):
            for l in self.leaves:  # a replicated view of a shared buffer (cuDNN's flat LSTM
                # weights) would keep the whole buffer alive at rest: give it its own storage
                if l.shard is None and l.param.untyped_storage().nbytes() > l.param.nbytes:
                    l.param.data = l.param.data.clone()
        self.release()

    def sharded(self) -> list[str]:
        """The names of the sharded leaves."""
        return [l.name for l in self.leaves if l.shard is not None]

    def gather(self):
        """Every sharded parameter's full weight, from the ranks' cuts."""
        for l in self.leaves:
            if l.shard is not None:
                l.param.data = dp.all_gather_shards(l.shard.data, l.axis, self.group)

    def release(self):
        """Free the full weights (and their gradients) of the sharded leaves."""
        for l in self.leaves:
            if l.shard is not None:
                l.param.data = l.shard.data.new_empty(0)
                l.param.grad = None

    @contextlib.contextmanager
    def gathered(self):
        self.gather()
        try:
            yield
        finally:
            self.release()

    def refresh(self):
        """Gather again after an update of the cuts, inside ``gathered``."""
        self.gather()

    def reduce(self):
        """Each sharded leaf's gradient reduce-scattered into its cut's (the
        mean over the ranks), the full gradient freed; the replicated ones
        mean-all-reduced."""
        replicated = []
        for l in self.leaves:
            g = l.param.grad if l.param.grad is not None else torch.zeros_like(l.param)
            if l.shard is None:
                l.param.grad = g
                replicated.append(g)
            else:
                l.shard.grad = dp.reduce_scatter_mean(g, l.axis, self.group)
                l.param.grad = None
        dp.all_reduce_mean_(replicated, self.group)

    def norm(self, grads) -> torch.Tensor:
        """The global norm of the gradients ``grads`` (``params``' order):
        the cuts' squares summed over the ranks, the replicated ones once."""
        cut = [g for l, g in zip(self.leaves, grads) if l.shard is not None]
        rep = [g for l, g in zip(self.leaves, grads) if l.shard is None]
        if not cut:  # the gradients are the same on every rank: the one-process norm
            return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(rep)))
        zero = grads[0].new_zeros(())

        def sq(gs):
            return torch.stack(torch._foreach_norm(gs)).square().sum() if gs else zero

        total = sq(cut).reshape(1)
        if self.group is not None:
            torch.distributed.all_reduce(total, group=self.group)
        return torch.sqrt(total[0] + sq(rep))

    def module_state_dict(self) -> dict:
        """The module's one-card state dict, every cut gathered (the
        replicated leaves are the live tensors, as ``state_dict`` gives)."""
        with self.gathered():
            return self.module.state_dict()

    def load_module_state_dict(self, sd: dict):
        """Load a one-card state dict: each sharded leaf's cut, the
        replicated leaves and the buffers whole."""
        own = {l.name for l in self.leaves} | {k for k, _ in self.module.named_buffers()}
        if set(sd) != own:
            raise KeyError(f"state dict keys differ: missing {sorted(own - set(sd))}, "
                           f"unexpected {sorted(set(sd) - own)}")
        n, r = dp.world(self.group), dp.rank(self.group)
        with torch.no_grad():
            for l in self.leaves:
                src = sd[l.name]
                if l.shard is None:
                    l.param.copy_(src)
                else:
                    l.shard.copy_(src.chunk(n, dim=l.axis)[r])
            for k, b in self.module.named_buffers():
                b.copy_(sd[k])

    def _moments(self, state: dict, fn) -> dict:
        out = {**state, "state": {}}
        for i, s in state["state"].items():
            l = self.leaves[int(i)]
            out["state"][i] = {k: (fn(v, l.axis) if l.shard is not None and torch.is_tensor(v)
                                   and v.dim() > 0 else v) for k, v in s.items()}
        return out

    def full_optim_state(self, state: dict) -> dict:
        """An AdamW state dict over the cuts -> the one-card one (the
        moments gathered)."""
        return self._moments(state, lambda v, axis: dp.all_gather_shards(v, axis, self.group))

    def local_optim_state(self, state: dict) -> dict:
        """A one-card AdamW state dict -> this rank's (the moments cut)."""
        n, r = dp.world(self.group), dp.rank(self.group)
        return self._moments(state, lambda v, axis: v.chunk(n, dim=axis)[r].clone())
