"""Finite scalar quantization (counterpart of
``audiotokenization_tpu/models/quantizers/fsq.py``; the reference's
``fsq: True``, configs/bigcodec_fsq.yaml).

A Linear ``project_in`` takes the latent width to len(levels) (none when
they are equal); each dim is bounded by a shifted tanh to about
[-(l - 1) / 2, (l - 1) / 2], rounded with a straight-through estimator and
divided by l // 2 into [-1, 1]; ``project_out`` takes it back. The index is
the mixed-radix sum of the levels (basis 1, l0, l0·l1, ...), int32.

What the tokens depend on: the whole quantizer runs in fp32 whatever the
caller's precision; ``_bound``'s atanh shift is computed in fp32, as the
JAX package computes it in the latents' dtype; ``torch.round`` rounds half
to even, as ``jnp.round`` does. ``torch.tanh`` and XLA's tanh differ by a
few fp32 ulps, so a bounded value within a few ulps of a .5 boundary may
round the other way in the two packages.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...ops.conv import init_linear, linear


def _levels(levels, device, dtype=torch.float32):
    """(levels, basis) as tensors: the levels in ``dtype``, the basis int32."""
    lv = np.asarray(levels, np.int32)
    basis = np.concatenate([[1], np.cumprod(lv[:-1])]).astype(np.int32)
    return (torch.tensor(lv, dtype=dtype, device=device),
            torch.tensor(basis, dtype=torch.int32, device=device))


def _bound(z, lv, eps: float = 1e-3):
    half_l = (lv - 1) * (1 + eps) / 2
    offset = torch.where(torch.remainder(lv, 2) == 0, 0.5, 0.0).to(z.dtype)
    shift = torch.atanh(offset / half_l)
    return torch.tanh(z + shift) * half_l - offset


def round_ste(z):
    """Round half to even, with the straight-through gradient."""
    return z + (torch.round(z) - z).detach()


def fsq_bounded(z, levels, *, preserve_symmetry: bool = False, generator=None):
    """The values ``fsq_quantize_codes`` rounds (z (..., d) fp32).

    ``preserve_symmetry``: 2/(L-1)·[(L-1)(tanh z + 1)/2 + 0.5] - 1;
    ``generator`` (training's noise-approximated quantization): tanh(z) +
    U(-1, 1)/(L-1), drawn from it; else the shifted-tanh bound."""
    lv, _ = _levels(levels, z.device, z.dtype)
    if generator is not None:
        noise = torch.rand(z.shape, generator=generator, device=z.device, dtype=z.dtype) * 2 - 1
        return torch.tanh(z) + noise / (lv - 1)
    if preserve_symmetry:
        return (2.0 / (lv - 1)) * ((lv - 1) * (torch.tanh(z) + 1) / 2.0 + 0.5) - 1.0
    return _bound(z, lv)


def fsq_quantize_codes(z, levels, *, preserve_symmetry: bool = False, generator=None):
    """z (..., d) fp32 -> normalised codes in [-1, 1], straight-through."""
    half_width = torch.tensor(np.asarray(levels, np.int32) // 2, dtype=z.dtype, device=z.device)
    bounded = fsq_bounded(z, levels, preserve_symmetry=preserve_symmetry, generator=generator)
    return round_ste(bounded) / half_width


def fsq_codes_to_indices(codes, levels):
    """codes (..., d) -> indices (...) int32."""
    lv, basis = _levels(levels, codes.device, codes.dtype)
    half_width = torch.div(lv, 2, rounding_mode="floor")
    zhat = codes * half_width + half_width
    return torch.sum(zhat * basis.to(codes.dtype), dim=-1).to(torch.int32)


def fsq_indices_to_codes(indices, levels):
    """indices (...) int -> codes (..., d) fp32."""
    lv, basis = _levels(levels, indices.device, torch.int64)
    level_idx = torch.remainder(torch.div(indices.long()[..., None], basis.long(),
                                          rounding_mode="floor"), lv)
    half_width = torch.div(lv, 2, rounding_mode="floor").float()
    return (level_idx.float() - half_width) / half_width


def fsq_implicit_codebook(levels):
    """Every code, (prod(levels), d) fp32, in index order."""
    return fsq_indices_to_codes(torch.arange(int(np.prod(levels))), levels)


class FSQ(nn.Module):
    """``project_in`` (dim -> len(levels)) and ``project_out`` (back), Linear
    with biases as in the JAX tree; no parameters when dim == len(levels)."""

    def __init__(self, *, dim: int, levels, generator: torch.Generator):
        super().__init__()
        self.levels = tuple(int(v) for v in levels)
        if dim != len(levels):
            self.project_in = init_linear(dim, len(levels), generator=generator)
            self.project_out = init_linear(len(levels), dim, generator=generator)


def fsq_apply(p: FSQ, z, *, preserve_symmetry: bool = False, generator=None):
    """z (B, dim, T) -> (quantized (B, dim, T), indices (B, T) int32), in fp32."""
    zt = z.float().transpose(1, 2)
    has_proj = hasattr(p, "project_in")
    proj = linear(zt, p.project_in) if has_proj else zt
    codes = fsq_quantize_codes(proj.float(), p.levels, preserve_symmetry=preserve_symmetry,
                               generator=generator)
    indices = fsq_codes_to_indices(codes, p.levels)
    out = linear(codes, p.project_out) if has_proj else codes
    return out.transpose(1, 2), indices


def fsq_codes_to_emb(p: FSQ, indices):
    """indices (B, T) -> project_out(codes) (B, T, dim)."""
    codes = fsq_indices_to_codes(indices, p.levels).to(indices.device)
    return linear(codes, p.project_out) if hasattr(p, "project_out") else codes


def _residual_scale(levels, i: int, device):
    """Level i's per-dim scale (levels - 1)^-i, computed in float64, fp32."""
    lv = np.asarray(levels, np.float64)
    return torch.tensor((lv - 1.0) ** -float(i), dtype=torch.float32, device=device)


def residual_fsq_apply(p: FSQ, z, *, num_quantizers: int):
    """Residual FSQ: level i quantizes residual / scale_i, de-scales,
    subtracts (detached) and accumulates. z (B, dim, T) -> (out (B, dim, T),
    indices (Nq, B, T) int32), in fp32."""
    zt = z.float().transpose(1, 2)
    has_proj = hasattr(p, "project_in")
    residual = (linear(zt, p.project_in) if has_proj else zt).float()
    out = torch.zeros_like(residual)
    idxs = []
    for i in range(num_quantizers):
        scale = _residual_scale(p.levels, i, z.device)
        codes = fsq_quantize_codes(residual / scale, p.levels)
        q = codes * scale
        idxs.append(fsq_codes_to_indices(codes, p.levels))
        residual = residual - q.detach()
        out = out + q
    if has_proj:
        out = linear(out, p.project_out)
    return out.transpose(1, 2), torch.stack(idxs)


def residual_fsq_codes_to_emb(p: FSQ, indices):
    """indices (Nq, B, T) -> the summed scaled codes, projected out (B, T, dim)."""
    out = sum(fsq_indices_to_codes(indices[i], p.levels).to(indices.device)
              * _residual_scale(p.levels, i, indices.device) for i in range(indices.shape[0]))
    return linear(out, p.project_out) if hasattr(p, "project_out") else out
