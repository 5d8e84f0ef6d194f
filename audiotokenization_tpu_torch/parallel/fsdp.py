"""FSDP, ZeRO-3 (counterpart of ``jit_train_step(..., fsdp=True)``, whose
GSPMD shardings ``parallel/mesh.py::fsdp_state_shardings`` places), plain
data parallelism as its case with no leaf cut, and the tensor-parallel
leaves held as cuts on the model devices (``parallel/tp.py``).

``ShardedParams`` takes one optimizer's module. Under ``fsdp`` each
parameter that ``mesh.fsdp_sharding_for`` shards (at least ``min_size``
elements, an axis the world size divides) is held at rest as this rank's
equal cut along that axis, and its AdamW moments are the cut's; the rest
stay replicated, as do the module's buffers (the EMA codebook). A
sharded parameter keeps its identity: between uses its storage is
resized to nothing, and a gather fills it again. Without ``fsdp`` every
leaf is replicated: the gradients are mean-all-reduced and the clip is the
one-process one. With a tensor-parallel context (``tp``) the leaves that
``tp.tp_spec_for_path`` names are held as cuts, one on each model device;
the cuts are the parameters the optimizer updates (their moments the
cuts'), the module's parameter is an empty placeholder that the TP hooks
map to the cuts, and the cuts' gradients are mean-all-reduced over the
ranks like a replicated leaf's.

A step gathers per block, as GSPMD's gathers per use do in JAX
(``per_block``): the blocks are the BigCodec's encoder and decoder blocks
and its ResLSTMs, the quantizer, each MPD and spectrogram sub-discriminator
and each Conformer layer (``block_types``); the model code runs each
through ``run_block``, which gathers the block's cuts just before its
forward, frees them after it, gathers them again when the gradient reaches
the block's outputs, and reduce-scatters each leaf's gradient into its
cut's (the mean over the ranks) as soon as autograd has accumulated it,
freeing the full gradient. One block at a time is full: a gather frees the
block gathered before. The leaves in no block (the
first and last convs, norms, heads) are gathered for the whole step.
Weight norm's ``v`` and ``g`` are one block's and gather together; a
mixed-precision cast of a block's leaves is made at the block
(``ops/params.py::deferred_cast``); the folded weight-norm weights and the
casts are recomputed from the gathered cuts in the backward rather than
kept from the forward (``remember``). The replicated gradients are
mean-all-reduced once an update (``reduce``), the clip takes the norm over
every cut and replicated leaf (``norm``), AdamW updates the cuts in place,
and the discriminator's leaves outside its blocks are gathered again after
its update (``refresh``), which the generator's loss reads.

The state dict is the one-card one: ``module_state_dict`` and
``full_optim_state`` gather every cut (a collective: every rank calls
them), and the loaders cut a full one back (``load_module_state_dict``,
``local_optim_state``), so a checkpoint moves between world sizes and
between TP and one device. ``gathered`` puts every full weight in place
for an evaluation pass.
"""
from __future__ import annotations

import contextlib
import types
import weakref
from dataclasses import dataclass, field
from typing import Optional

import torch
from torch import nn

from . import dp
from .mesh import fsdp_sharding_for

# The step's blocks, the one gathered now and the forward's remembered
# tensors: process-wide, not per thread, since autograd runs a CUDA
# backward (its hooks and a checkpoint's recompute) on a thread of its own
# while the step's thread waits in ``backward``.
_state = types.SimpleNamespace(units={}, slot=None, derived=None)


def block_types() -> tuple:
    """The module types a step gathers one at a time (module docstring)."""
    from ..models.bigcodec import DecoderBlock, EncoderBlock
    from ..models.discriminators import PeriodDiscriminator, SpecDiscriminator
    from ..ops.transformer import ConformerLayer

    return (EncoderBlock, DecoderBlock, nn.LSTM, PeriodDiscriminator, SpecDiscriminator,
            ConformerLayer)


def blocks_of(module: nn.Module) -> list:
    """(prefix, block) of ``module``'s blocks: the ``block_types`` and a
    codec's ``quantizer``, outermost first; nothing inside a block."""
    types = block_types()
    out = []

    def walk(prefix, m):
        for name, child in m.named_children():
            path = f"{prefix}{name}"
            if isinstance(child, types) or (prefix == "" and name == "quantizer"):
                out.append((path, child))
            else:
                walk(path + ".", child)

    walk("", module)
    return out


@dataclass
class _Leaf:
    name: str
    param: nn.Parameter
    axis: Optional[int] = None       # FSDP: the cut axis (None: not cut over the ranks)
    shard: Optional[nn.Parameter] = None
    tp_dim: Optional[int] = None     # TP: the dim cut over the model devices
    cuts: list = field(default_factory=list)
    index: list = field(default_factory=list)  # its parameters' places in ``params``


@dataclass(eq=False)
class _Unit:
    """The FSDP-cut leaves of one block (``module``), or of the rest of the
    module (``module`` None); ``names`` relative to the block."""
    owner: "ShardedParams"
    module: Optional[nn.Module]
    leaves: list
    names: list
    full: bool = False


def _set_storage(t: torch.Tensor, nbytes: int):
    t.untyped_storage().resize_(nbytes)


def _fill(t: torch.Tensor, full: torch.Tensor):
    """Write ``full`` into ``t``'s storage, sized to hold it (no autograd
    version bump: ``t``'s saved uses read it in the backward)."""
    _set_storage(t, full.numel() * full.element_size())
    t.data.copy_(full)


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def remember(out: torch.Tensor, fn, *inputs) -> torch.Tensor:
    """``out = fn(*inputs)``, computed from parameters alone (a weight-norm
    fold, a cast): inside ``run_block`` the backward recomputes it from the
    gathered parameters instead of keeping it from the forward (a full
    copy of the block's weights otherwise lives until its backward). An
    input that is neither a parameter nor so remembered leaves ``out`` as
    it is."""
    derived = _state.derived
    if derived is None:
        return out
    recipes = []
    for t in inputs:
        if isinstance(t, nn.Parameter):
            recipes.append(lambda t=t: t)
        else:
            hit = derived.get(t.untyped_storage().data_ptr())
            if hit is None or hit[0]() is not t:
                return out
            recipes.append(hit[1])
    derived[out.untyped_storage().data_ptr()] = (
        weakref.ref(out), lambda: fn(*(r() for r in recipes)))
    return out


def _pack(t):
    key = t.untyped_storage().data_ptr()
    hit = _state.derived.get(key) if key else None
    if hit is None or hit[0]() is None or hit[0]().untyped_storage().data_ptr() != key:
        return t
    return hit[1], t.size(), t.stride(), t.storage_offset()


def _unpack(saved):
    if torch.is_tensor(saved):
        return saved
    recipe, size, stride, offset = saved
    with torch.no_grad():
        return recipe().as_strided(size, stride, offset)


def run_block(module: nn.Module, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, ``module`` being one block of a step's
    ``ShardedParams`` (module docstring): its cuts gathered for the body and
    again for its backward, reached through the output tensors (every tensor
    of the result, nested in lists, tuples and dicts); the tensors computed
    from its weights alone (``remember``) recomputed in the backward rather
    than kept, unless a checkpoint already keeps nothing. Outside such a step
    it is the call itself."""
    unit = _state.units.get(id(module))
    if unit is None:
        return fn(*args, **kwargs)
    from ..ops.params import deferred_cast, parameters_as

    unit.owner.use(unit)
    prev, _state.derived = _state.derived, {}
    subs = {}
    for name, l in zip(unit.names, unit.leaves):
        t = deferred_cast(l.param, l.param)
        if t is not l.param:
            subs[name] = remember(t, lambda p, dtype=t.dtype: p.detach().to(dtype), l.param)
    hooks = contextlib.nullcontext()
    if torch._C._autograd._top_saved_tensors_default_hooks(True) is None:
        hooks = torch.autograd.graph.saved_tensors_hooks(_pack, _unpack)
    try:
        with parameters_as(module, subs), hooks:
            out = fn(*args, **kwargs)
    finally:
        _state.derived = prev
        # a checkpoint's recompute runs inside the backward, whose next nodes
        # read what it saves: the block stays until the next gather frees it
        if torch._C._current_graph_task_id() == -1:
            unit.owner.free(unit)

    def again(_grad, unit=unit):
        unit.owner.use(unit)

    for t in _tensors(out):
        if t.requires_grad:
            t.register_hook(again)
    return out


class ShardedParams:
    """One module's parameters over ``group``'s ranks and ``tp``'s model
    devices (module docstring). ``params`` are what the optimizer updates:
    each leaf's cut, TP cuts, or the parameter itself where it is
    replicated."""

    def __init__(self, module: nn.Module, group, *, fsdp: bool = True,
                 min_size: int = 2 ** 14, tp=None):
        from .tp import tp_spec_for_path

        self.module = module
        self.group = group
        self.tp = tp
        n, r = dp.world(group), dp.rank(group)
        self.leaves = []
        self.params = []
        for name, p in module.named_parameters():
            l = _Leaf(name, p)
            spec = tp_spec_for_path(name) if tp is not None else None
            if spec is not None:
                l.tp_dim = spec.index("model")
                if p.shape[l.tp_dim] % tp.n:
                    raise ValueError(f"TP leaf {name} shape {tuple(p.shape)} not divisible by "
                                     f"model={tp.n}")
                l.cuts = [nn.Parameter(c.to(d).contiguous().clone()) for c, d in
                          zip(torch.tensor_split(p.detach(), tp.n, l.tp_dim), tp.devices)]
                tp.hold(p, l.cuts, l.tp_dim)
            elif fsdp and group is not None:
                l.axis = fsdp_sharding_for(p.shape, n, min_size=min_size)
                if l.axis is not None:
                    l.shard = nn.Parameter(p.detach().chunk(n, dim=l.axis)[r].contiguous().clone())
            own = l.cuts or ([l.shard] if l.shard is not None else [p])
            l.index = list(range(len(self.params), len(self.params) + len(own)))
            self.params.extend(own)
            self.leaves.append(l)
        if any(l.shard is not None or l.cuts for l in self.leaves):
            for l in self.leaves:  # every leaf its own storage: a view of a shared buffer
                # (cuDNN's flat LSTM weights) would keep the whole buffer alive at rest,
                # and a cut leaf's storage is emptied between uses
                if l.param.untyped_storage().nbytes() > l.param.nbytes or l.shard is not None \
                        or l.cuts:
                    l.param.data = l.param.data.clone()
            for l in self.leaves:
                if l.shard is not None or l.cuts:
                    _set_storage(l.param, 0)
                    l.param.deferred = bool(l.cuts)  # TP: cast where the cut is read
                if l.shard is not None:
                    l.param.register_post_accumulate_grad_hook(self._scatter_hook(l))
        self.units = self._units()
        self._stepping = False

    # -- blocks -------------------------------------------------------------------

    def _units(self) -> list:
        cut = {id(l.param): l for l in self.leaves if l.shard is not None}
        if not cut:
            return []
        units, seen = [], set()
        for prefix, block in blocks_of(self.module):
            mine = [(n, cut[id(p)]) for n, p in block.named_parameters() if id(p) in cut]
            if mine:
                units.append(_Unit(self, block, [l for _, l in mine], [n for n, _ in mine]))
                seen.update(id(l.param) for _, l in mine)
                for _, l in mine:
                    l.param.deferred = True  # gathered (and cast) at its block
        rest = [l for l in cut.values() if id(l.param) not in seen]
        if rest:
            units.append(_Unit(self, None, rest, [l.name for l in rest]))
        return units

    def _scatter_hook(self, l: _Leaf):
        def hook(p):
            if not self._stepping:
                return
            g, p.grad = p.grad, None
            s = dp.reduce_scatter_mean(g, l.axis, self.group)
            l.shard.grad = s if l.shard.grad is None else l.shard.grad.add_(s)

        return hook

    def _gather_unit(self, unit: _Unit):
        with torch.no_grad():
            for l in unit.leaves:
                if l.axis == 0:  # straight into the parameter's storage
                    _set_storage(l.param, l.param.nbytes)
                    torch.distributed.all_gather_into_tensor(l.param.data, l.shard.data,
                                                             group=self.group)
                else:
                    _fill(l.param, dp.all_gather_shards(l.shard.data, l.axis, self.group))
        unit.full = True

    def free(self, unit: _Unit):
        for l in unit.leaves:
            _set_storage(l.param, 0)
        unit.full = False
        if _state.slot is unit:
            _state.slot = None

    def use(self, unit: _Unit):
        """Gather ``unit``'s cuts (a block: after freeing the block gathered
        before it)."""
        if unit.full:
            return
        slot = _state.slot
        if slot is not None:
            slot.owner.free(slot)
        self._gather_unit(unit)
        _state.slot = unit

    @contextlib.contextmanager
    def per_block(self):
        """The step's gathers (module docstring): the blocks at their use
        (``run_block``), the rest now, all freed at the end."""
        units = _state.units
        mine = [u for u in self.units if u.module is not None]
        for u in mine:
            units[id(u.module)] = u
        self._stepping = True
        try:
            for u in self.units:
                if u.module is None:
                    self._gather_unit(u)
            yield
        finally:
            self._stepping = False
            for u in self.units:
                self.free(u)
            for u in mine:
                units.pop(id(u.module), None)

    def refresh(self):
        """After an update inside ``per_block``: the leaves outside the
        blocks gathered again from the updated cuts, a gathered block freed."""
        for u in self.units:
            if u.full:
                self.free(u)
            if u.module is None:
                self._gather_unit(u)

    # -- whole-module gathers (evaluation, state dicts) -----------------------------

    def sharded(self) -> list[str]:
        """The names of the FSDP-cut leaves."""
        return [l.name for l in self.leaves if l.shard is not None]

    def tp_leaves(self) -> list[str]:
        """The names of the TP leaves."""
        return [l.name for l in self.leaves if l.cuts]

    def gather(self):
        """Every cut parameter's full weight in place (TP's on the module's
        device), from the ranks' cuts and the model devices' cuts."""
        for u in self.units:
            if not u.full:
                self._gather_unit(u)
        with torch.no_grad():
            for l in self.leaves:
                if l.cuts:
                    _fill(l.param, torch.cat([c.to(l.param.device) for c in l.cuts], l.tp_dim))

    def release(self):
        """Free the full weights of the cut leaves (and their gradients)."""
        for u in self.units:
            self.free(u)
        for l in self.leaves:
            if l.cuts:
                _set_storage(l.param, 0)
            if l.shard is not None or l.cuts:
                l.param.grad = None

    @contextlib.contextmanager
    def gathered(self):
        self.gather()
        try:
            yield
        finally:
            self.release()

    # -- the update -------------------------------------------------------------------

    def reduce(self):
        """The replicated leaves' and the TP cuts' gradients mean-all-reduced;
        a cut leaf's gradient is its cut's, reduce-scattered in the backward
        (zeros where none reached it)."""
        replicated = []
        for l in self.leaves:
            if l.shard is not None:
                if l.shard.grad is None:
                    l.shard.grad = torch.zeros_like(l.shard)
                continue
            for p in l.cuts or [l.param]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                replicated.append(p.grad)
        if self.group is not None:
            for dev in dict.fromkeys(g.device for g in replicated):
                dp.all_reduce_mean_([g for g in replicated if g.device == dev], self.group)

    def norm(self, grads) -> torch.Tensor:
        """The global norm of the gradients ``grads`` (``params``' order):
        the FSDP cuts' squares summed over the ranks, the replicated ones and
        the TP cuts once, on the first gradient's device."""
        dev = grads[0].device
        cut = [g for l in self.leaves if l.shard is not None for g in [grads[l.index[0]]]]
        rep = [grads[i] for l in self.leaves if l.shard is None for i in l.index]

        def norms(gs):
            return torch.stack([n.to(dev) for d in dict.fromkeys(g.device for g in gs)
                                for n in torch._foreach_norm([g for g in gs if g.device == d])])

        if not cut:  # the gradients are the same on every rank: the one-process norm
            return torch.linalg.vector_norm(norms(rep))
        zero = grads[0].new_zeros(())

        def sq(gs):
            return norms(gs).square().sum() if gs else zero

        total = sq(cut).reshape(1)
        if self.group is not None:
            torch.distributed.all_reduce(total, group=self.group)
        return torch.sqrt(total[0] + sq(rep))

    # -- the one-card state dict -----------------------------------------------------

    def module_state_dict(self) -> dict:
        """The module's one-card state dict, every cut gathered (copies of the
        cut leaves, on the module's device; the replicated leaves are the
        live tensors, as ``state_dict`` gives)."""
        cut = {l.name for l in self.leaves if l.shard is not None or l.cuts}
        with self.gathered():
            return {k: (v.clone() if k in cut else v) for k, v in self.module.state_dict().items()}

    def load_module_state_dict(self, sd: dict):
        """Load a one-card state dict: each cut leaf's cuts, the replicated
        leaves and the buffers whole."""
        own = {l.name for l in self.leaves} | {k for k, _ in self.module.named_buffers()}
        if set(sd) != own:
            raise KeyError(f"state dict keys differ: missing {sorted(own - set(sd))}, "
                           f"unexpected {sorted(set(sd) - own)}")
        n, r = dp.world(self.group), dp.rank(self.group)
        with torch.no_grad():
            for l in self.leaves:
                src = sd[l.name]
                if l.cuts:
                    for c, part in zip(l.cuts, torch.tensor_split(src, len(l.cuts), l.tp_dim)):
                        c.copy_(part)
                elif l.shard is None:
                    l.param.copy_(src)
                else:
                    l.shard.copy_(src.chunk(n, dim=l.axis)[r])
            for k, b in self.module.named_buffers():
                b.copy_(sd[k])

    def full_optim_state(self, state: dict) -> dict:
        """An AdamW state dict over ``params`` -> the one-card one, indexed by
        the module's parameters (the FSDP moments gathered over the ranks,
        the TP cuts' moments joined)."""
        out = {"state": {}, "param_groups": [
            {**g, "params": list(range(len(self.leaves)))} for g in state["param_groups"]]}
        for i, l in enumerate(self.leaves):
            parts = [state["state"].get(j) for j in l.index]
            if parts[0] is None:
                continue
            if l.cuts:
                dev = l.param.device
                out["state"][i] = {k: (torch.cat([p[k].to(dev) for p in parts], l.tp_dim)
                                       if torch.is_tensor(v) and v.dim() > 0 else v)
                                   for k, v in parts[0].items()}
            elif l.shard is not None:
                out["state"][i] = {k: (dp.all_gather_shards(v, l.axis, self.group)
                                       if torch.is_tensor(v) and v.dim() > 0 else v)
                                   for k, v in parts[0].items()}
            else:
                out["state"][i] = parts[0]
        return out

    def local_optim_state(self, state: dict) -> dict:
        """A one-card AdamW state dict -> this rank's (the FSDP moments cut,
        the TP moments split over the model devices)."""
        n, r = dp.world(self.group), dp.rank(self.group)
        out = {"state": {}, "param_groups": [
            {**g, "params": list(range(len(self.params)))} for g in state["param_groups"]]}
        for i, l in enumerate(self.leaves):
            s = state["state"].get(i, state["state"].get(str(i)))
            if s is None:
                continue
            for k, j in enumerate(l.index):
                def part(v, k=k):
                    if not (torch.is_tensor(v) and v.dim() > 0):
                        return v.clone() if torch.is_tensor(v) else v
                    if l.cuts:
                        return torch.tensor_split(v, len(l.cuts), l.tp_dim)[k].clone()
                    if l.shard is not None:
                        return v.chunk(n, dim=l.axis)[r].clone()
                    return v
                out["state"][j] = {key: part(v) for key, v in s.items()}
        return out
