"""Factorized vector quantization — the tokenizer's codebook search.

Counterpart of ``audiotokenization_tpu/models/quantizers/factorized_vq.py``.
The flagship uses one quantizer with a (8192, 8) codebook and weight-normed
1024 <-> 8 projections. What the token gate depends on:

- the argmin runs on the **L2-normalised** projected latents and codebook,
  fp32 (‖e‖² - 2e·c) + ‖c‖², lowest index on ties (K1, ``vq_argmin``);
- the lookup uses the **raw** codebook — normalising is for the argmin only;
- training loss 0.25·mse(z_e, sg[z_q]) + mse(z_q, sg[z_e]) per sample, zeros
  in eval; straight-through z_e + sg[z_q - z_e].
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops.conv import init_wn_linear, linear
from ...ops.cuda.vq_kernel import l2_normalize, vq_argmin  # noqa: F401  (l2_normalize re-exported)


def nearest_code_indices(z_e, codebook):
    """z_e (B, D, T) projected latents; codebook (N, D). Returns (B, T) int32."""
    B, D, T = z_e.shape
    enc = z_e.transpose(1, 2).reshape(B * T, D).float().contiguous()
    return vq_argmin(enc, codebook.float().contiguous()).reshape(B, T)


class FactorizedVQ(nn.Module):
    """One FactorizedVectorQuantize layer: ``in_proj``/``out_proj`` (when the
    widths differ) and the ``codebook`` (N, D), initialised N(0, 1)."""

    def __init__(self, *, dim: int, codebook_size: int, codebook_dim: int,
                 generator: torch.Generator):
        super().__init__()
        if dim != codebook_dim:
            self.in_proj = init_wn_linear(dim, codebook_dim, generator=generator)
            self.out_proj = init_wn_linear(codebook_dim, dim, generator=generator)
        self.codebook = nn.Parameter(
            torch.randn((codebook_size, codebook_dim), generator=generator))


class ResidualVQ(nn.Module):
    def __init__(self, *, num_quantizers: int, dim: int, codebook_size: int,
                 codebook_dim: int, generator: torch.Generator):
        super().__init__()
        self.layers = nn.ModuleList(
            FactorizedVQ(dim=dim, codebook_size=codebook_size,
                         codebook_dim=codebook_dim, generator=generator)
            for _ in range(num_quantizers))


def factorized_vq_apply(p: FactorizedVQ, z, *, commitment: float = 0.25,
                        training: bool = False):
    """z (B, dim, T) -> (z_q (B, dim, T), indices (B, T), commit_loss (B,))."""
    B = z.shape[0]
    has_proj = hasattr(p, "in_proj")
    z_e = linear(z.transpose(1, 2), p.in_proj) if has_proj else z.transpose(1, 2)
    z_e = z_e.transpose(1, 2)  # (B, D, T)
    indices = nearest_code_indices(z_e, p.codebook)
    z_q = p.codebook[indices.long()].transpose(1, 2).to(z_e.dtype)  # (B, D, T)
    if training:
        commit_loss = (commitment * torch.mean((z_e - z_q.detach()) ** 2, dim=(1, 2))
                       + torch.mean((z_q - z_e.detach()) ** 2, dim=(1, 2)))
    else:
        commit_loss = torch.zeros((B,), dtype=z.dtype, device=z.device)
    z_q = z_e + (z_q - z_e).detach()  # straight-through
    z_q = z_q.transpose(1, 2)
    if has_proj:
        z_q = linear(z_q, p.out_proj)
    return z_q.transpose(1, 2), indices, commit_loss


def residual_vq_apply(p: ResidualVQ, x, *, num_quantizers: int,
                      commitment: float = 0.25, training: bool = False,
                      shared_codebook: bool = False):
    """Returns (quantized (B, dim, T), indices (Nq, B, T), losses (Nq,)).
    ``shared_codebook``: layer 0's parameters at every level (lucidrains
    residual_vq.py:153-157)."""
    quantized_out = torch.zeros_like(x)
    residual = x
    all_indices, all_losses = [], []
    for q in range(num_quantizers):
        quantized, indices, loss = factorized_vq_apply(
            p.layers[0 if shared_codebook else q], residual, commitment=commitment,
            training=training)
        residual = residual - quantized
        quantized_out = quantized_out + quantized
        all_indices.append(indices)
        all_losses.append(torch.mean(loss))
    return quantized_out, torch.stack(all_indices), torch.stack(all_losses)


def residual_vq_codes_to_emb(p: ResidualVQ, codes, *, proj: bool = True):
    """codes (B, T, Nq) int -> summed embeddings (B, T, dim)."""
    out = 0.0
    for q, layer in enumerate(p.layers):
        emb = layer.codebook[codes[:, :, q].long()]
        if proj and hasattr(layer, "out_proj"):
            emb = linear(emb, layer.out_proj)
        out = out + emb
    return out
