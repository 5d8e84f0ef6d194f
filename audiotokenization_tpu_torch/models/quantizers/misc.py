"""The quantizer zoo's smaller members (counterpart of
``audiotokenization_tpu/models/quantizers/misc.py``): SimVQ,
the BEST-RQ random-projection quantizer, the residual and grouped
combinators over any quantizer, and NSVQ. No codec config selects them;
they are library quantizers, held to JAX's by the tests.

- SimVQ: a frozen random codebook (a buffer) through a learned linear
  ``transform``; gradients move the transform only.
- Random projection (BEST-RQ): a frozen xavier-normal projection and an
  l2-normalised frozen codebook (both buffers); indices only.
- NSVQ (noise substitution): in training the quantized vector is
  z + ‖z - z_q‖·ε/‖ε‖, ε ~ N(0, I) handed in (``noise``) or drawn from
  ``generator``, differentiable in z and the codebook; no loss.

Every distance is fp32 ‖x‖² - 2x·c + ‖c‖², lowest index on ties.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from ...ops.conv import init_linear, linear


def _flat(x):
    B, D, T = x.shape
    return x.transpose(1, 2).reshape(-1, D).float()


def _unflat(flat, like):
    B, D, T = like.shape
    return flat.reshape(B, T, D).transpose(1, 2).to(like.dtype)


def _nearest(flat, codebook):
    dist = ((flat * flat).sum(1, keepdim=True) - 2 * flat @ codebook.T
            + (codebook * codebook).sum(1)[None])
    return torch.argmin(dist, dim=1)


class SimVQ(nn.Module):
    """``frozen_codebook`` (N, D) N(0, 1), a buffer, and ``transform``, a
    Linear D -> D."""

    def __init__(self, *, codebook_size: int, dim: int, generator: torch.Generator):
        super().__init__()
        self.register_buffer("frozen_codebook",
                             torch.randn((codebook_size, dim), generator=generator))
        self.transform = init_linear(dim, dim, generator=generator)


def sim_vq_apply(p: SimVQ, x, *, commit_weight: float = 0.25, training: bool = False):
    """x (B, D, T) -> (quantized (B, D, T), indices (B, T) int32, loss (B,));
    the codebook is transform(frozen_codebook)."""
    B, D, T = x.shape
    flat = _flat(x)
    codebook = linear(p.frozen_codebook.detach(), p.transform)
    indices = _nearest(flat, codebook)
    quantized = codebook[indices]
    if training:
        commit = commit_weight * torch.mean(((flat - quantized.detach()) ** 2).reshape(B, T, D),
                                            dim=(1, 2))
        codebook_loss = torch.mean(((quantized - flat.detach()) ** 2).reshape(B, T, D), dim=(1, 2))
        loss = commit + codebook_loss
    else:
        loss = torch.zeros((B,), device=x.device)
    q = flat + (quantized - flat).detach()
    return _unflat(q, x), indices.to(torch.int32).reshape(B, T), loss


class RandomProjectionQuantizer(nn.Module):
    """``projection`` (codebook_dim, dim), xavier normal, and ``codebook``
    (N, codebook_dim), l2-normalised N(0, 1): both frozen buffers."""

    def __init__(self, *, dim: int, codebook_dim: int, codebook_size: int,
                 generator: torch.Generator):
        super().__init__()
        std = (2.0 / (dim + codebook_dim)) ** 0.5
        self.register_buffer("projection",
                             std * torch.randn((codebook_dim, dim), generator=generator))
        cb = torch.randn((codebook_size, codebook_dim), generator=generator)
        self.register_buffer("codebook", cb / torch.linalg.vector_norm(cb, dim=-1, keepdim=True))


def random_projection_quantize(p: RandomProjectionQuantizer, x):
    """x (B, D, T) -> indices (B, T) int32 (nothing learns)."""
    B, D, T = x.shape
    z = _flat(x) @ p.projection.T
    z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True).clamp_min(1e-12)
    dist = -2 * z @ p.codebook.T  # the norms are constant after normalising
    return torch.argmin(dist, dim=1).to(torch.int32).reshape(B, T)


def residual_quantize(apply_fns: Sequence[Callable], x):
    """Each fn maps (B, D, T) -> (q, indices, loss); fn i quantizes what the
    first i left. Returns (Σ q, indices (n, ...), mean losses (n,))."""
    quantized_out = torch.zeros_like(x)
    residual = x
    all_idx, all_loss = [], []
    for fn in apply_fns:
        q, idx, loss = fn(residual)
        residual = residual - q
        quantized_out = quantized_out + q
        all_idx.append(idx)
        all_loss.append(torch.mean(loss))
    return quantized_out, torch.stack(all_idx), torch.stack(all_loss)


def grouped_quantize(apply_fns: Sequence[Callable], x):
    """The channels split into len(apply_fns) equal groups, each quantized by
    its fn. Returns (quantized, indices (n, ...), mean losses (n,))."""
    n = len(apply_fns)
    if x.shape[1] % n:
        raise ValueError(f"{x.shape[1]} channels do not split into {n} equal groups")
    outs = [fn(g) for fn, g in zip(apply_fns, x.chunk(n, dim=1))]
    return (torch.cat([o[0] for o in outs], dim=1), torch.stack([o[1] for o in outs]),
            torch.stack([torch.mean(o[2]) for o in outs]))


class NSVQ(nn.Module):
    """``codebook`` (N, D) N(0, 1), a parameter."""

    def __init__(self, *, codebook_size: int, dim: int, generator: torch.Generator):
        super().__init__()
        self.codebook = nn.Parameter(torch.randn((codebook_size, dim), generator=generator))


def nsvq_apply(p: NSVQ, x, *, noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None, training: bool = False):
    """x (B, D, T) -> (quantized (B, D, T), indices (B, T) int32, zeros (B,)).
    Training substitutes z + ‖z - z_q‖·ε/‖ε‖ (ε: ``noise`` (B·T, D), else
    drawn from ``generator``); eval is the nearest code."""
    B, D, T = x.shape
    flat = _flat(x)
    cb = p.codebook
    indices = _nearest(flat, cb)
    zq = cb[indices]
    if training:
        if noise is None:
            if generator is None:
                raise ValueError("nsvq_apply(training=True) needs noise or a generator")
            noise = torch.randn(flat.shape, generator=generator)
        eps = noise.to(flat.device, flat.dtype)
        err = torch.linalg.vector_norm(flat - zq, dim=-1, keepdim=True)
        unit = eps / torch.linalg.vector_norm(eps, dim=-1, keepdim=True).clamp_min(1e-12)
        out = flat + err * unit
    else:
        out = zq
    loss = torch.zeros((B,), device=x.device)
    return _unflat(out, x), indices.to(torch.int32).reshape(B, T), loss
