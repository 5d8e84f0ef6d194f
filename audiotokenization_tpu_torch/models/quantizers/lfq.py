"""Lookup-free quantization, LFQ / BSQ (counterpart of
``audiotokenization_tpu/models/quantizers/lfq.py``; the reference's
lucidrains LFQ).

A code is the sign bits of the latent's D dims (D = codebook_dim bits, an
implicit codebook of 2^D codes), index Σ bit_d·2^d (int32). Training adds
the entropy aux loss (low per-sample entropy, high batch-average entropy
over the 2^D codes; ``process_group`` averages the batch's code
probabilities over the processes, where JAX takes ``pmean``) and the
commitment loss. ``spherical`` (BSQ) l2-normalises the latents and scales
the codes by 1/sqrt(D); ``codebook_scale`` shrinks them (residual stacks).
The 2^D implicit codebook is built only in training: at D = 13 it is 8192
codes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class LFQResult(NamedTuple):
    quantized: torch.Tensor         # (B, D, T), x's dtype
    indices: torch.Tensor           # (B, T) int32
    entropy_aux_loss: torch.Tensor  # () fp32
    commit_loss: torch.Tensor       # (B,) fp32


def _bits(indices, dim: int):
    """indices (...) int -> their dim low bits (..., dim) fp32."""
    return ((indices.long()[..., None] >> torch.arange(dim, device=indices.device)) & 1).float()


def lfq_apply(x, *, codebook_dim: Optional[int] = None, spherical: bool = False,
              entropy_weight: float = 0.1, commit_weight: float = 0.25,
              diversity_gamma: float = 1.0, inv_temperature: float = 100.0,
              training: bool = False, process_group=None,
              codebook_scale: float = 1.0) -> LFQResult:
    """x (B, D, T) with D = codebook_dim bits -> LFQResult, codes in
    {-scale, scale}, straight-through."""
    B, D, T = x.shape
    flat = x.transpose(1, 2).reshape(-1, D).float()
    scale = codebook_scale
    if spherical:
        scale = codebook_scale / np.sqrt(D)
        flat = flat / torch.linalg.vector_norm(flat, dim=-1, keepdim=True).clamp_min(1e-12)
    positive = flat > 0
    codes = torch.where(positive, scale, -scale).to(flat.dtype)
    powers = 2 ** torch.arange(D, device=flat.device, dtype=torch.int32)
    indices = (positive.to(torch.int32) * powers).sum(1, dtype=torch.int32)

    entropy_aux = torch.zeros((), device=flat.device)
    commit = torch.zeros((B,), device=flat.device)
    if training:
        all_codes = (_bits(torch.arange(2 ** D, device=flat.device), D) * 2.0 - 1.0) * scale
        logits = 2.0 * inv_temperature * (flat @ all_codes.T)
        probs = torch.softmax(logits, dim=-1)
        per_sample_entropy = torch.mean(-torch.sum(probs * torch.log_softmax(logits, -1), dim=-1))
        avg_probs = probs.mean(0)
        if process_group is not None:
            import torch.distributed as dist
            import torch.distributed.nn.functional as dist_fn

            avg_probs = dist_fn.all_reduce(avg_probs, group=process_group) / dist.get_world_size(
                process_group)
        codebook_entropy = -torch.sum(avg_probs * torch.log(avg_probs + 1e-9))
        entropy_aux = entropy_weight * (per_sample_entropy - diversity_gamma * codebook_entropy)
        commit = commit_weight * torch.mean(((flat - codes.detach()) ** 2).reshape(B, T, D),
                                            dim=(1, 2))
    q = flat + (codes - flat).detach()
    return LFQResult(q.reshape(B, T, D).transpose(1, 2).to(x.dtype), indices.reshape(B, T),
                     entropy_aux, commit)


def lfq_indices_to_codes(indices, *, codebook_dim: int, spherical: bool = False,
                         codebook_scale: float = 1.0):
    """indices (...) int -> codes (..., codebook_dim) fp32."""
    scale = codebook_scale / np.sqrt(codebook_dim) if spherical else codebook_scale
    return (_bits(indices, codebook_dim) * 2.0 - 1.0) * scale
