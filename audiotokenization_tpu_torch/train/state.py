"""The train state: the generator (``Codec``), the discriminators, one
optimizer for each and the step (counterpart of
``audiotokenization_tpu/train/state.py``).

Each optimizer computes what the JAX package's
``optax.chain(clip_by_global_norm(c), adamw(schedule, b1=.8, b2=.9,
eps=1e-8, weight_decay=.01))`` computes:

- the gradients are scaled by c / ‖g‖ (the global norm over every leaf of
  the side) only where ‖g‖ >= c; no +1e-6 as ``clip_grad_norm_`` adds;
- AdamW decays **every** leaf, biases, snake α/β, weight-norm g and the
  codebook included; the EMA quantizer's state is buffers, not
  parameters, which no optimizer sees (the JAX step decays those leaves
  and then overwrites them with the forward's state; the step writes it
  here, ``train/step.py``), and which the state dict saves;
- the learning rate of update k (k counted from 0, one count per
  optimizer) is schedule(k).

Over several ranks (``group``) each optimizer takes a ``sync``: data
parallelism all-reduces the gradients before the clip; FSDP (``train.fsdp``)
cuts the parameters and moments and clips by the norm over every rank's
cut. The state dict keeps the one-card layout either way.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..config import Config, OptimParams, ScheduleParams
from ..models.codec import Codec, resolve_device
from ..models.discriminators import Discriminator
from .schedule import warmup_lr_schedule


def _schedule(s: ScheduleParams):
    return warmup_lr_schedule(warmup_step=s.warmup_step, down_step=s.down_step,
                              max_lr=s.max_lr, min_lr=s.min_lr)


class ClippedAdamW:
    """Global-norm clipping, then ``torch.optim.AdamW`` at the schedule's
    learning rate, over the parameters of one module. ``sync``
    (``parallel/fsdp.py::ShardedParams``) spreads it over ranks: data
    parallelism, or FSDP, whose cuts are the parameters updated here; None
    in one process."""

    def __init__(self, module: nn.Module, optim: OptimParams, schedule: ScheduleParams,
                 clip: float, *, sync=None):
        self.module = module
        self.sync = sync
        self.params = list(sync.params if sync is not None else module.parameters())
        self.clip = float(clip)
        self.schedule = _schedule(schedule)
        self.count = 0  # updates applied
        self.adamw = torch.optim.AdamW(
            self.params, lr=self.schedule(0), betas=tuple(optim.betas), eps=optim.eps,
            weight_decay=optim.weight_decay, fused=self.params[0].is_cuda or None)

    def zero_grad(self):
        for p in self.params:
            p.grad = None
        if self.sync is not None:  # FSDP: the full weights' gradients too
            for p in self.module.parameters():
                p.grad = None

    def grads(self) -> list[torch.Tensor]:
        """Every parameter's gradient, zeros where none reached it (optax
        updates such a leaf too: its moments decay and it is decayed)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.params]

    def reduce_grads(self):
        """The ranks' gradients reduced (``sync``); once per update."""
        if self.sync is not None:
            self.sync.reduce()

    def gathered(self):
        """The module's full weights within the body (FSDP)."""
        return self.sync.gathered() if self.sync is not None else contextlib.nullcontext()

    def step(self):
        grads = self.grads()
        if self.sync is not None:
            norm = self.sync.norm(grads)
        else:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        torch._foreach_mul_(grads, self.clip / torch.clamp_min(norm, self.clip))
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.count += 1

    def refresh(self):
        """After ``step``, inside ``gathered``: the module's full weights
        gathered again from the updated cuts (FSDP), where the step reads
        them once more."""
        if self.sync is not None:
            self.sync.refresh()

    def module_state_dict(self) -> dict:
        """The module's state dict, one-card layout (FSDP gathers it)."""
        return self.sync.module_state_dict() if self.sync is not None else self.module.state_dict()

    def load_module_state_dict(self, sd: dict):
        if self.sync is not None:
            self.sync.load_module_state_dict(sd)
        else:
            self.module.load_state_dict(sd)

    def state_dict(self) -> dict:
        """The update count (the schedule's index) and AdamW's state: its
        moments and step, live tensors (no copies; FSDP's moments gathered
        into the one-card layout)."""
        adamw = self.adamw.state_dict()
        if self.sync is not None:
            adamw = self.sync.full_optim_state(adamw)
        return {"count": self.count, "adamw": adamw}

    def load_state_dict(self, sd: dict):
        """Restores ``state_dict()``'s content. This optimizer keeps its own
        implementation flags (fused on the card, not on the CPU), so a state
        saved on one device loads on another; AdamW places the moments and
        step on the parameters' device. A one-card state loads under any
        ``sync`` (FSDP cuts the moments)."""
        own = ("fused", "foreach", "capturable", "differentiable")
        groups = [{**saved, **{k: cur[k] for k in own if k in cur}}
                  for saved, cur in zip(sd["adamw"]["param_groups"], self.adamw.param_groups)]
        state = {"state": sd["adamw"]["state"], "param_groups": groups}
        if self.sync is not None:
            state = self.sync.local_optim_state(state)
        self.adamw.load_state_dict(state)
        self.count = int(sd["count"])


def make_optimizers(cfg: Config, gen: nn.Module, disc: nn.Module, *, group=None,
                    fsdp: bool = False, fsdp_min_size: int = 2 ** 14):
    """Each side's optimizer; over ``group``'s ranks data-parallel, or with
    ``fsdp`` sharded (``parallel/fsdp.py``)."""
    t = cfg.train

    def sync(module):
        if group is None:
            return None
        from ..parallel.fsdp import ShardedParams

        return ShardedParams(module, group, fsdp=fsdp, min_size=fsdp_min_size)

    return (ClippedAdamW(gen, t.gen_optim_params, t.gen_schedule_params, t.gen_grad_clip,
                         sync=sync(gen)),
            ClippedAdamW(disc, t.disc_optim_params, t.disc_schedule_params, t.disc_grad_clip,
                         sync=sync(disc)))


@dataclass
class TrainState:
    gen: Codec
    disc: Discriminator
    gen_opt: ClippedAdamW
    disc_opt: ClippedAdamW
    step: int = 0

    def state_dict(self) -> dict:
        """Everything a resume needs: both modules' parameters, both
        optimizers (moments, AdamW steps, update counts) and the step. The
        tensors are the live ones."""
        return {"step": self.step, "gen": self.gen_opt.module_state_dict(),
                "disc": self.disc_opt.module_state_dict(), "gen_opt": self.gen_opt.state_dict(),
                "disc_opt": self.disc_opt.state_dict()}

    def load_state_dict(self, sd: dict):
        """Copies ``state_dict()``'s content into this state's own tensors,
        in place, so the optimizers keep their parameters."""
        self.gen_opt.load_module_state_dict(sd["gen"])
        self.disc_opt.load_module_state_dict(sd["disc"])
        self.gen_opt.load_state_dict(sd["gen_opt"])
        self.disc_opt.load_state_dict(sd["disc_opt"])
        self.step = int(sd["step"])


def train_state(cfg: Config, gen: Codec, disc: Discriminator, *, group=None,
                fsdp: Optional[bool] = None, fsdp_min_size: int = 2 ** 14) -> TrainState:
    """A state at step 0 around the given modules (already on their device):
    training mode, fresh optimizers (zero moments). ``group``: the ranks of
    a data-parallel run (every rank holds the same weights), sharded by
    ``fsdp`` (default ``train.fsdp``) over leaves of ``fsdp_min_size``
    elements or more."""
    gen.train()  # cuDNN's LSTM has no backward in eval mode; nothing else differs
    disc.train()
    fsdp = cfg.train.fsdp if fsdp is None else fsdp
    gen_opt, disc_opt = make_optimizers(cfg, gen, disc, group=group, fsdp=fsdp,
                                        fsdp_min_size=fsdp_min_size)
    return TrainState(gen, disc, gen_opt, disc_opt)


def init_train_state(cfg: Config, *, generator: torch.Generator, device="cuda", group=None,
                     fsdp: Optional[bool] = None, fsdp_min_size: int = 2 ** 14) -> TrainState:
    """Random weights drawn on the CPU from ``generator`` (the codec's, then
    the discriminators'), moved to ``device``; raises without a card
    unless ``device="cpu"``. ``group``, ``fsdp``, ``fsdp_min_size``: as
    ``train_state`` (every rank draws the same weights from the same
    seed)."""
    device = resolve_device(device)
    gen = Codec(cfg, generator=generator).to(device)
    disc = Discriminator(cfg, generator=generator).to(device)
    return train_state(cfg, gen, disc, group=group, fsdp=fsdp, fsdp_min_size=fsdp_min_size)
