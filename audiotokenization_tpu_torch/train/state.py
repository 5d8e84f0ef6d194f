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
cut. Tensor parallelism (``train.tensor_parallel``) holds the generator's
TP leaves as cuts on the model devices (the same ``sync``,
``parallel/fsdp.py::ShardedParams`` with a ``parallel/tp.py::TPContext``);
pipeline parallelism (``train.pipeline_parallel``) moves each stage's
Conformer layers to its device (``parallel/pp.py::pp_place``), and the
optimizer updates the parameters where they are. The state dict keeps the
one-card layout in every case.
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
        """The module's full weights within the body (FSDP's cuts gathered,
        TP's joined): an evaluation pass."""
        return self.sync.gathered() if self.sync is not None else contextlib.nullcontext()

    def per_block(self):
        """A training step's body: FSDP's cuts gathered per block
        (``parallel/fsdp.py::run_block``)."""
        return self.sync.per_block() if self.sync is not None else contextlib.nullcontext()

    def step(self):
        grads = self.grads()
        devices = list(dict.fromkeys(g.device for g in grads))
        if self.sync is not None:
            norm = self.sync.norm(grads)
        else:
            norm = torch.linalg.vector_norm(torch.stack(
                [n.to(devices[0]) for d in devices
                 for n in torch._foreach_norm([g for g in grads if g.device == d])]))
        scale = self.clip / torch.clamp_min(norm, self.clip)
        for d in devices:  # TP cuts and pipeline stages: parameters on several devices
            torch._foreach_mul_([g for g in grads if g.device == d], scale.to(d))
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.count += 1

    def refresh(self):
        """After ``step``, inside ``per_block``: the weights outside the
        blocks gathered again from the updated cuts (FSDP), where the step
        reads them once more."""
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
                    fsdp: bool = False, fsdp_min_size: int = 2 ** 14, tp=None):
    """Each side's optimizer; over ``group``'s ranks data-parallel, or with
    ``fsdp`` sharded (``parallel/fsdp.py``); the generator's TP leaves held
    as cuts on ``tp``'s model devices (a ``parallel/tp.py::TPContext``)."""
    t = cfg.train

    def sync(module, tp=None):
        if group is None and tp is None:
            return None
        from ..parallel.fsdp import ShardedParams

        return ShardedParams(module, group, fsdp=fsdp, min_size=fsdp_min_size, tp=tp)

    return (ClippedAdamW(gen, t.gen_optim_params, t.gen_schedule_params, t.gen_grad_clip,
                         sync=sync(gen, tp)),
            ClippedAdamW(disc, t.disc_optim_params, t.disc_schedule_params, t.disc_grad_clip,
                         sync=sync(disc)))


@dataclass
class TrainState:
    gen: Codec
    disc: Discriminator
    gen_opt: ClippedAdamW
    disc_opt: ClippedAdamW
    step: int = 0
    model_devices: Optional[list] = None  # TP's model devices or PP's stage devices

    @property
    def tp(self):
        """The generator's ``TPContext`` under tensor parallelism, else None."""
        sync = self.gen_opt.sync
        return None if sync is None else sync.tp

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


def model_axis(cfg: Config) -> tuple:
    """("tp" | "pp" | None, its size) of ``train.tensor_parallel`` /
    ``train.pipeline_parallel``; both above 1 raise (JAX's refusal)."""
    tp_n = max(int(cfg.train.tensor_parallel), 1)
    pp_n = max(int(cfg.train.pipeline_parallel), 1)
    if tp_n > 1 and pp_n > 1:
        raise ValueError("tensor_parallel and pipeline_parallel both >1 is "
                         "not composed yet; pick one model axis")
    return ("tp", tp_n) if tp_n > 1 else ("pp", pp_n) if pp_n > 1 else (None, 1)


def train_state(cfg: Config, gen: Codec, disc: Discriminator, *, group=None,
                fsdp: Optional[bool] = None, fsdp_min_size: int = 2 ** 14,
                model_devices=None) -> TrainState:
    """A state at step 0 around the given modules (already on their device,
    the first model device's): training mode, fresh optimizers (zero
    moments). ``group``: the ranks of a data-parallel run (every rank holds
    the same weights), sharded by ``fsdp`` (default ``train.fsdp``) over
    leaves of ``fsdp_min_size`` elements or more. ``model_devices``: under
    ``train.tensor_parallel`` the model devices the TP leaves are cut over,
    under ``train.pipeline_parallel`` the stages' devices, one a stage
    (``parallel/tp.py``, ``parallel/pp.py``; a device may repeat)."""
    gen.train()  # cuDNN's LSTM has no backward in eval mode; nothing else differs
    disc.train()
    fsdp = cfg.train.fsdp if fsdp is None else fsdp
    kind, n = model_axis(cfg)
    tp = None
    if kind is not None:
        model_devices = [torch.device(d) for d in model_devices or ()]
        if len(model_devices) != n:
            raise ValueError(f"train.{'tensor' if kind == 'tp' else 'pipeline'}_parallel={n} "
                             f"needs {n} model devices, {len(model_devices)} were given")
    if kind == "tp":
        from ..parallel.tp import TPContext, validate_tp

        validate_tp(cfg, n)
        tp = TPContext(model_devices, differentiable=True)
    elif kind == "pp":
        from ..parallel.pp import pp_place

        if fsdp:
            raise ValueError("fsdp + pipeline_parallel is not composed "
                             "yet; pick one memory axis")
        pp_place(gen, cfg, model_devices)
    gen_opt, disc_opt = make_optimizers(cfg, gen, disc, group=group, fsdp=fsdp,
                                        fsdp_min_size=fsdp_min_size, tp=tp)
    return TrainState(gen, disc, gen_opt, disc_opt,
                      model_devices=model_devices if kind is not None else None)


def init_train_state(cfg: Config, *, generator: torch.Generator, device="cuda", group=None,
                     fsdp: Optional[bool] = None, fsdp_min_size: int = 2 ** 14,
                     model_devices=None) -> TrainState:
    """Random weights drawn on the CPU from ``generator`` (the codec's, then
    the discriminators'), moved to ``device``; raises without a card
    unless ``device="cpu"``. ``group``, ``fsdp``, ``fsdp_min_size``,
    ``model_devices``: as ``train_state`` (every rank draws the same weights
    from the same seed), placed before any restore."""
    device = resolve_device(device)
    gen = Codec(cfg, generator=generator).to(device)
    disc = Discriminator(cfg, generator=generator).to(device)
    return train_state(cfg, gen, disc, group=group, fsdp=fsdp, fsdp_min_size=fsdp_min_size,
                       model_devices=model_devices)
