"""Mixture-of-experts SwiGLU feed-forward (counterpart of
``audiotokenization_tpu/ops/moe.py``): GShard top-k routing with a fixed
expert capacity, Switch Transformer aux losses.

Routing, as the JAX package routes (``route``):

- the router (``router.w``, (E, d), no bias) runs in fp32 in every
  precision and tokenize mode, on fp32 copies of the activations and of
  its weight, with TF32 off on the card (a TF32 router would move near-tie
  routing decisions that fp32 keeps);
- each token's top-k experts by probability, the lower index first among
  equal probabilities (``jax.lax.top_k``'s order; a stable sort here, since
  ``torch.topk`` promises no order among ties, which a uniform router
  gives);
- capacity = max(1, int(capacity_factor · N · top_k / E)) slots per expert
  for N tokens, in Python float arithmetic;
- slots are claimed **choice-major**: every token's first choice in
  row-major (B, T) order, then every token's second, ...; a (token,
  choice) past its expert's capacity is dropped, and a pad token under
  ``token_mask`` claims no slot. A token that all its choices drop gets
  zero from the layer (the residual carries it);
- in a data-parallel step (``parallel/dp.py``) N, the order of the claims
  and the load balance's f and P are the global batch's, rank 0's tokens
  first, as JAX's data-mesh step routes the whole batch: each rank offsets
  its slots by the all-gathered (top_k, E) claim counts of the ranks and
  choices before it.

Dispatch is by index, not by the JAX package's (N, E, C) one-hot einsums
(65 MB a tensor and 8.4 GFLOP a layer at 32 x 1 s of configs/conformer_moe.yaml):
the kept tokens are copied into an (E, C, d) buffer (zeros in empty slots),
the experts run as batched matmuls over E, and each output row, times its
gate, is added back into its token's row in fp32; a dropped pair goes to a
spare row with gate 0, so no step waits on the host. Each slot of the JAX
dispatch einsum has one non-zero term, and each token's combine at most
``top_k``, so the numbers are the same.

The experts' stacked weights (``w1``, ``w3`` (E, h, d), ``w2`` (E, d, h))
are cast to the activations' dtype (a no-op where the caller already
holds bf16 copies, as the bf16 training step does once a step).
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import dp
from ..parallel.tp import constrain_heads, tp_model_shards, tp_shard
from .conv import init_linear, kaiming_uniform_fan_in


class MoEFeedForward(nn.Module):
    """The router (``router.w`` (E, d)) and E stacked SwiGLU experts, named
    as in the JAX tree; hidden width ``swiglu_hidden_dim(dim, ffn_mult)``."""

    def __init__(self, dim: int, *, n_experts: int, ffn_mult: int = 4,
                 generator: torch.Generator):
        super().__init__()
        from .transformer import swiglu_hidden_dim

        hidden = swiglu_hidden_dim(dim, ffn_mult)
        self.router = init_linear(dim, n_experts, bias=False, generator=generator)

        def stacked(out_f, in_f):
            return nn.Parameter(torch.stack([kaiming_uniform_fan_in((out_f, in_f),
                                                                    generator=generator)
                                             for _ in range(n_experts)]))

        self.w1 = stacked(hidden, dim)
        self.w2 = stacked(dim, hidden)
        self.w3 = stacked(hidden, dim)


class Routing(NamedTuple):
    logits: torch.Tensor  # (N, E) fp32
    probs: torch.Tensor   # (N, E) fp32
    gates: torch.Tensor   # (N, k) fp32: the probabilities of the chosen experts
    experts: torch.Tensor  # (N, k) int64, the higher probability first
    slots: torch.Tensor   # (N, k) int64: the slot within the expert's buffer
    keep: torch.Tensor    # (N, k) bool: dispatched (within capacity, not a pad token)
    capacity: int


@contextlib.contextmanager
def _fp32_matmul():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def route(xt, router_w, *, top_k: int, capacity_factor: float, token_mask=None) -> Routing:
    """The routing of tokens xt (N, d) (module docstring); ``token_mask``
    (N,) bool, False on pad tokens."""
    N = xt.shape[0]
    E = router_w.shape[0]
    with _fp32_matmul():
        logits = xt.float() @ router_w.float().t()
    probs = torch.softmax(logits, dim=-1)
    group = dp.active_group()  # a data-parallel step: the global batch's tokens
    capacity = max(1, int(capacity_factor * (N * dp.world(group)) * top_k / E))
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[:, :top_k], experts[:, :top_k]
    # choice-major claims: column c * N + n is token n's choice c. The
    # running count goes along the last (contiguous) dim: a scan down the
    # first dim of a (k·N, E) one-hot is a serial loop per expert on the
    # card (half a tokenize's device time on an H100, PERF.md §6)
    flat = experts.t().reshape(-1)
    claims = flat[None, :] == torch.arange(E, device=xt.device)[:, None]  # (E, k·N)
    if token_mask is not None:
        claims = claims & token_mask.repeat(top_k)[None, :]
    slots = (torch.cumsum(claims, dim=1) - 1).gather(0, flat[None, :])[0]
    slots = slots.reshape(top_k, N).t()
    if group is not None:
        offsets = _global_slot_offsets(claims, top_k, group)
        slots = slots + offsets[torch.arange(top_k, device=xt.device)[None, :], experts]
    keep = slots < capacity
    if token_mask is not None:
        keep = keep & token_mask[:, None]
    return Routing(logits, probs, gates, experts, slots, keep, capacity)


def _global_slot_offsets(claims, top_k: int, group):
    """(k, E): what to add to this rank's slot of a claim of choice c on
    expert e to give its slot in the global batch's choice-major order, in
    which rank 0's tokens come first: every rank's claims of the choices
    before c, plus the earlier ranks' claims of choice c, less this rank's
    own claims of the earlier choices (its local count holds them)."""
    E = claims.shape[0]
    local = claims.reshape(E, top_k, -1).sum(-1).t()  # (k, E)
    every = dp.all_gather_rows(local[None], group)  # (ranks, k, E)
    total = every.sum(0)
    return (torch.cumsum(total, 0) - total + every[:dp.rank(group)].sum(0)
            - (torch.cumsum(local, 0) - local))


def dispatch(xt, r: Routing):
    """The (E, C, d) expert inputs: each kept (token, choice) in its slot,
    zeros in the empty ones. Returns (buffer, the token of each (token,
    choice) pair, its flat slot index, its gate): a dropped pair's index is
    the spare row E·C past the buffer and its gate 0, so that nothing waits
    on the host for the count of kept pairs."""
    N, d = xt.shape
    E, k = r.probs.shape[1], r.experts.shape[1]
    keep = r.keep.reshape(-1)
    token = torch.arange(N, device=xt.device).repeat_interleave(k)
    flat = torch.where(keep, (r.experts * r.capacity + r.slots).reshape(-1), E * r.capacity)
    buf = xt.new_zeros(E * r.capacity + 1, d).index_copy(0, flat, xt[token])
    return buf[:-1].reshape(E, r.capacity, d), token, flat, r.gates.reshape(-1) * keep


def _swiglu_experts(buf, w1, w2, w3):
    w1, w2, w3 = (w.to(buf.dtype) for w in (w1, w2, w3))
    h = F.silu(torch.bmm(buf, w1.transpose(1, 2))) * torch.bmm(buf, w3.transpose(1, 2))
    return torch.bmm(h, w2.transpose(1, 2))


def experts_apply(buf, p: MoEFeedForward):
    """Every expert's SwiGLU over its slots: (E, C, d) -> (E, C, d). Under
    a TP context (``parallel/tp.py``) the experts are split over the model
    devices, each running its share's slots on its device (expert
    parallelism; an expert's output is computed whole, so the numbers are
    the same)."""
    n = tp_model_shards()
    if not n:
        return _swiglu_experts(buf, p.w1, p.w2, p.w3)
    outs = [_swiglu_experts(constrain_heads(part, s), *(tp_shard(w, 0, s)
                                                        for w in (p.w1, p.w2, p.w3)))
            for s, part in enumerate(torch.tensor_split(buf, n))]
    return torch.cat([o.to(buf.device) for o in outs])


def combine(expert_out, token, flat, gates, n_tokens: int):
    """Each pair's expert output (row ``flat`` of ``expert_out`` (E, C, d);
    the spare row past it, zeros, for a dropped pair) times its gate
    (rounded to the activations' dtype, as JAX's combine tensor is), summed
    into its token's row in fp32 and cast back: (n_tokens, d)."""
    d = expert_out.shape[-1]
    rows = torch.cat([expert_out.reshape(-1, d), expert_out.new_zeros(1, d)])
    y = rows[flat].float() * gates.to(expert_out.dtype).float()[:, None]
    out = torch.zeros(n_tokens, d, dtype=torch.float32, device=expert_out.device)
    return out.index_add(0, token, y).to(expert_out.dtype)


def aux_losses(r: Routing, token_mask=None) -> dict:
    """Switch aux losses in fp32: E · Σ f_e P_e (f_e: the share of tokens
    whose first choice is e; P_e: the mean router probability), the router
    z-loss mean(logsumexp(logits)²), and the share of (token, choice) pairs
    dropped (without gradient); over the valid tokens under a mask."""
    E, k = r.probs.shape[1], r.experts.shape[1]
    top1 = (r.experts[:, :1] == torch.arange(E, device=r.experts.device)).float()
    lse2 = torch.logsumexp(r.logits, dim=-1) ** 2
    group = dp.active_group()  # a data-parallel step: f and P over the global batch
    w = torch.ones_like(lse2) if token_mask is None else token_mask.float()
    n_valid = torch.clamp(dp.global_sum(w.sum(), group), min=1.0)
    f = dp.global_sum((top1 * w[:, None]).sum(0), group) / n_valid
    pmean = dp.global_sum((r.probs * w[:, None]).sum(0), group) / n_valid
    z = dp.global_sum((lse2 * w).sum(), group) / n_valid
    with torch.no_grad():
        dropped = 1.0 - dp.global_sum(r.keep.float().sum(), group) / (n_valid * k)
    return {"load_balance_loss": E * torch.sum(f * pmean), "router_z_loss": z,
            "dropped_frac": dropped}


def moe_ffn(x, p: MoEFeedForward, *, top_k: int = 2, capacity_factor: float = 1.25,
            token_mask=None, losses: bool = True):
    """x (B, T, d) -> (out (B, T, d), aux): the layer over every token, with
    the aux losses (``aux_losses``; None without ``losses``, which spares
    serving their kernels). ``token_mask`` (B, T) bool: pad tokens claim no
    slot and leave the router statistics alone; capacity is still a
    function of the batch's B · T tokens, so a ragged MoE result depends on
    the batch it rode in."""
    B, T, d = x.shape
    xt = x.reshape(B * T, d)
    tmask = None if token_mask is None else token_mask.reshape(-1)
    r = route(xt, p.router.w, top_k=top_k, capacity_factor=capacity_factor, token_mask=tmask)
    buf, token, flat, gates = dispatch(xt, r)
    out = combine(experts_apply(buf, p), token, flat, gates, B * T)
    return out.reshape(B, T, d), aux_losses(r, tmask) if losses else None


def moe_ffn_dense_reference(x, p: MoEFeedForward, *, top_k: int = 2):
    """Capacity-free oracle: every token reaches all its top-k experts
    (every expert computes every token). Tests only."""
    B, T, d = x.shape
    xt = x.reshape(-1, d)
    r = route(xt, p.router.w, top_k=top_k, capacity_factor=1.0)  # its slots go unused
    h = F.silu(torch.einsum("nd,ehd->neh", xt, p.w1)) * torch.einsum("nd,ehd->neh", xt, p.w3)
    every = torch.einsum("neh,edh->ned", h, p.w2)
    gate = torch.zeros_like(r.probs).scatter(1, r.experts, r.gates)
    return torch.einsum("ned,ne->nd", every, gate.to(xt.dtype)).reshape(B, T, d)
