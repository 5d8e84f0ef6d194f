"""QINCo residual VQ, implicit neural codebooks (counterpart of
``audiotokenization_tpu/models/quantizers/qinco.py``; Huijben et al.,
arXiv 2401.14732; the reference's ``ResidualVQ(implicit_neural_codebook=
True)``).

Stage 0 is nearest-code VQ on its codebook; each later stage i passes its
codebook through an MLP conditioned on the running quantized sum, so each
position quantizes against its own (N, D) codebook. The MLP's first Linear
over concat(condition, code) is split (``w_cond``, ``w_code``): two
(·, D) x (D, D) products broadcast-added into the (m, N, D) pair tensor,
never the (m, N, 2D) concat. ``chunk_size`` bounds that tensor: positions
run in chunks of that many, a Python loop. Codebooks and MLPs are
gradient-learned parameters.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn


class QincoResult(NamedTuple):
    quantized: torch.Tensor  # (B, D, T)
    indices: torch.Tensor    # (Nq, B, T) int32
    loss: torch.Tensor       # (B,): commitment + codebook losses summed over the stages


def _uniform(shape, lim, generator):
    return nn.Parameter(torch.empty(shape).uniform_(-lim, lim, generator=generator))


class QincoBlock(nn.Module):
    """Linear(dim -> hidden) -> SiLU -> Linear(hidden -> dim), residual."""

    def __init__(self, dim: int, hidden: int, generator: torch.Generator):
        super().__init__()
        self.w1 = _uniform((hidden, dim), dim ** -0.5, generator)
        self.b1 = _uniform((hidden,), dim ** -0.5, generator)
        self.w2 = _uniform((dim, hidden), hidden ** -0.5, generator)
        self.b2 = _uniform((dim,), hidden ** -0.5, generator)


class QincoMLP(nn.Module):
    """The first Linear(2·dim -> dim) split into ``w_cond`` and ``w_code``
    (D, D) and ``b_in``, then ``depth`` residual blocks; torch's default
    Linear init."""

    def __init__(self, dim: int, dim_hidden: Optional[int] = None, depth: int = 4, *,
                 generator: torch.Generator):
        super().__init__()
        lim = (2 * dim) ** -0.5
        self.w_cond = _uniform((dim, dim), lim, generator)
        self.w_code = _uniform((dim, dim), lim, generator)
        self.b_in = _uniform((dim,), lim, generator)
        self.blocks = nn.ModuleList(QincoBlock(dim, dim_hidden or dim, generator)
                                    for _ in range(depth))


class Qinco(nn.Module):
    """``codebooks`` (Nq, N, D) N(0, 1) and one ``QincoMLP`` per stage >= 1."""

    def __init__(self, *, num_quantizers: int, codebook_size: int, dim: int,
                 dim_hidden: Optional[int] = None, mlp_depth: int = 4,
                 generator: torch.Generator):
        super().__init__()
        self.codebooks = nn.Parameter(
            torch.randn((num_quantizers, codebook_size, dim), generator=generator))
        self.mlps = nn.ModuleList(QincoMLP(dim, dim_hidden, mlp_depth, generator=generator)
                                  for _ in range(num_quantizers - 1))


def qinco_mlp_apply(p: QincoMLP, codes, condition, *, l2norm_output: bool = False):
    """codes (N, D), condition (M, D) -> per-position codebooks (M, N, D)."""
    x = (condition @ p.w_cond.T)[:, None, :] + (codes @ p.w_code.T)[None] + p.b_in
    for blk in p.blocks:
        x = F.silu(x @ blk.w1.T + blk.b1) @ blk.w2.T + blk.b2 + x
    if l2norm_output:
        x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)
    return x


def _chunks(m: int, chunk_size: Optional[int]):
    step = chunk_size or max(m, 1)
    return [slice(i, min(i + step, m)) for i in range(0, m, step)]


def _stage(flat, codebook, mlp, cond, *, chunk_size: Optional[int]):
    """One residual stage over positions flat (M, D) -> (q (M, D), idx (M,))."""
    if mlp is None:
        dist = ((flat * flat).sum(1, keepdim=True) - 2 * flat @ codebook.T
                + (codebook * codebook).sum(1)[None])
        idx = torch.argmin(dist, dim=1)
        return codebook[idx], idx
    qs, idxs = [], []
    for s in _chunks(flat.shape[0], chunk_size):
        tcb = qinco_mlp_apply(mlp, codebook, cond[s])  # (m, N, D)
        i = torch.argmin(((flat[s, None, :] - tcb) ** 2).sum(-1), dim=1)
        qs.append(tcb[torch.arange(len(i), device=i.device), i])
        idxs.append(i)
    return torch.cat(qs), torch.cat(idxs)


def qinco_apply(p: Qinco, x, *, commit_weight: float = 0.25, training: bool = False,
                chunk_size: Optional[int] = None) -> QincoResult:
    """x (B, D, T) -> QincoResult; stage i >= 1 is conditioned on the sum of
    the stages before it."""
    B, D, T = x.shape
    flat = x.transpose(1, 2).reshape(-1, D).float()
    residual = flat
    quantized_out = torch.zeros_like(flat)
    all_idx, losses = [], []
    for i, mlp in enumerate([None, *p.mlps]):
        q, idx = _stage(residual, p.codebooks[i], mlp, quantized_out, chunk_size=chunk_size)
        if training:
            commit = commit_weight * torch.mean(((residual - q.detach()) ** 2).reshape(B, T, D),
                                                dim=(1, 2))
            codebook_loss = torch.mean(((q - residual.detach()) ** 2).reshape(B, T, D), dim=(1, 2))
            losses.append(commit + codebook_loss)
        q_ste = residual + (q - residual).detach()
        residual = residual - q.detach()
        quantized_out = quantized_out + q_ste
        all_idx.append(idx.to(torch.int32).reshape(B, T))
    loss = sum(losses) if losses else torch.zeros((B,), device=x.device)
    out = quantized_out.reshape(B, T, D).transpose(1, 2).to(x.dtype)
    return QincoResult(out, torch.stack(all_idx), loss)


def qinco_codes_to_emb(p: Qinco, indices, *, chunk_size: Optional[int] = None):
    """indices (Nq, B, T) -> (B, D, T): each stage's codebook re-derived from
    the running sum, as ``qinco_apply`` quantized it."""
    Nq, B, T = indices.shape
    D = p.codebooks.shape[-1]
    out = torch.zeros((B * T, D), device=indices.device)
    for i, mlp in enumerate([None, *p.mlps]):
        cb = p.codebooks[i]
        idx = indices[i].reshape(-1).long()
        if mlp is None:
            out = out + cb[idx]
            continue
        add = []
        for s in _chunks(out.shape[0], chunk_size):
            tcb = qinco_mlp_apply(mlp, cb, out[s])
            add.append(tcb[torch.arange(tcb.shape[0], device=idx.device), idx[s]])
        out = out + torch.cat(add)
    return out.reshape(B, T, D).transpose(1, 2)
