"""Latent quantization (counterpart of
``audiotokenization_tpu/models/quantizers/latent_quantize.py``; the
reference's lucidrains latent_quantization): each latent dim is quantized
alone against its own L learned ``values``, with commitment and
quantization losses and a straight-through estimator; the index is the
mixed-radix sum Σ level_d·L^d (int32). ``residual_vq_with_dropout`` is the
quantize-dropout residual stack, its two draws explicit.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn

from ...ops.conv import init_linear, linear


class LatentQuantize(nn.Module):
    """``values`` (codebook_dim, levels_per_dim) U(-0.5, 0.5) and, when dim
    differs from codebook_dim, Linear ``project_in`` / ``project_out``."""

    def __init__(self, *, levels_per_dim: int, codebook_dim: int, dim: Optional[int] = None,
                 generator: torch.Generator):
        super().__init__()
        self.values = nn.Parameter(
            torch.empty((codebook_dim, levels_per_dim)).uniform_(-0.5, 0.5, generator=generator))
        if dim is not None and dim != codebook_dim:
            self.project_in = init_linear(dim, codebook_dim, generator=generator)
            self.project_out = init_linear(codebook_dim, dim, generator=generator)


def latent_quantize_apply(p: LatentQuantize, z, *, commitment: float = 0.25,
                          quant_weight: float = 1.0, training: bool = False):
    """z (B, D, T) -> (quantized (B, D, T), indices (B, T) int32, loss (B,))."""
    B = z.shape[0]
    has_proj = hasattr(p, "project_in")
    x = z.transpose(1, 2)
    x = linear(x, p.project_in) if has_proj else x
    values = p.values  # (d, L)
    d, L = values.shape
    level_idx = torch.argmin(torch.abs(x[..., None] - values), dim=-1)  # (B, T, d)
    quant = values[torch.arange(d, device=z.device), level_idx]
    if training:
        loss = (commitment * torch.mean((x - quant.detach()) ** 2, dim=(1, 2))
                + quant_weight * torch.mean((quant - x.detach()) ** 2, dim=(1, 2)))
    else:
        loss = torch.zeros((B,), dtype=z.dtype, device=z.device)
    q = x + (quant - x).detach()
    basis = L ** torch.arange(d, device=z.device, dtype=torch.int32)
    indices = (level_idx.to(torch.int32) * basis).sum(-1, dtype=torch.int32)
    out = linear(q, p.project_out) if has_proj else q
    return out.transpose(1, 2), indices, loss


def residual_vq_with_dropout(apply_fns, x, *, dropout_prob: float = 0.5, training: bool = False,
                             draws: Optional[Mapping[str, torch.Tensor]] = None,
                             generator: Optional[torch.Generator] = None):
    """Quantize-dropout residual stack (lucidrains residual_vq.py:177-182):
    in training, with probability ``dropout_prob``, only a random prefix of
    n in [1, len] quantizers contributes (the rest give zero). The draws:
    ``draws["dropout"]`` (bool) and ``draws["n"]`` (int), else from
    ``generator``. Returns (quantized, indices (n_q, ...), losses (n_q,),
    n_used)."""
    n_q = len(apply_fns)
    n_used = torch.tensor(n_q)
    if training and n_q > 1:
        draws = draws or {}
        if not {"dropout", "n"} <= set(draws) and generator is None:
            raise ValueError("residual_vq_with_dropout(training=True) needs its draws "
                             "or a generator")
        use = (draws["dropout"] if "dropout" in draws
               else torch.rand((), generator=generator) < dropout_prob)
        n = draws["n"] if "n" in draws else torch.randint(1, n_q + 1, (), generator=generator)
        n_used = torch.where(torch.as_tensor(use), torch.as_tensor(n), n_used)
    quantized_out = torch.zeros_like(x)
    residual = x
    all_idx, all_loss = [], []
    for i, fn in enumerate(apply_fns):
        q, idx, loss = fn(residual)
        active = (i < n_used).to(x.dtype)
        q = q * active
        residual = residual - q
        quantized_out = quantized_out + q
        all_idx.append(idx)
        all_loss.append(torch.mean(loss) * active)
    return quantized_out, torch.stack(all_idx), torch.stack(all_loss), n_used
