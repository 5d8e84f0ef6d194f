"""Plain PyTorch pieces the references share: weight norm, snake, RMS norm,
the factorized VQ's search, and the parameter spec's init kinds.

A reference works on a flat dict ``P`` of tensors named as the program's
state dict names them (``encoder.conv_in.v``, ...), and recomputes from
those tensors whatever it needs (weight norm, normalised codebook).
Imports torch and numpy only.
"""
from __future__ import annotations

import numpy as np
import torch


class Spec(tuple):
    """(name, shape, init): init is one of ``fan_in`` (U(+-1/sqrt(prod(shape[1:])))),
    ``fan_in:<n>`` (U(+-1/sqrt(n))), ``wn_g:<v name>`` (the norm of v over
    every dim but 0), ``normal``, ``snake`` (U(+-0.3)), ``norm`` (U(0.8, 1.2)),
    ``bias`` (U(+-0.1))."""

    def __new__(cls, name, shape, init):
        return super().__new__(cls, (name, tuple(int(s) for s in shape), init))


def wn_specs(name, shape, *, transpose=False):
    """A weight-normed layer's v, g and bias b; a transpose conv's weight is
    (in, out, k) and its bias (out,)."""
    return [Spec(f"{name}.v", shape, "fan_in"),
            Spec(f"{name}.g", (shape[0],) + (1,) * (len(shape) - 1), f"wn_g:{name}.v"),
            Spec(f"{name}.b", (shape[1] if transpose else shape[0],), "bias")]


def wn_weight(P, name):
    """g * v / |v|, the norm over every dim but 0."""
    v, g = P[f"{name}.v"], P[f"{name}.g"]
    n = torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.ndim)), keepdim=True))
    return v * (g / n)


def snake_beta(x, P, name):
    """x + sin^2(e^alpha x) / (e^beta + 1e-9), per channel of (B, C, T)."""
    a = torch.exp(P[f"{name}.alpha"])[None, :, None]
    b = torch.exp(P[f"{name}.beta"])[None, :, None]
    s = torch.sin(x * a)
    return x + (1.0 / (b + 1e-9)) * (s * s)


def rms_norm(x, weight=None, eps=1e-6):
    """fp32 RMS norm over the last dim, times ``weight``."""
    y = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return y if weight is None else y * weight


def vq_specs(cfg):
    d = cfg["model"]["codec_decoder"]
    dim, cd, n = d["in_channels"], d["codebook_dim"], d["codebook_size"]
    out = []
    for q in range(d.get("vq_num_quantizers", 1)):
        pre = f"quantizer.layers.{q}"
        out.append(Spec(f"{pre}.codebook", (n, cd), "normal"))
        out += wn_specs(f"{pre}.in_proj", (cd, dim))
        out += wn_specs(f"{pre}.out_proj", (dim, cd))
    return out


def _normalize(x):
    return x / torch.clamp_min(torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)), 1e-12)


def vq_distances(P, latents):
    """latents (C, F) of one utterance -> (F, N) squared distances between the
    L2-normalised projected latents and the L2-normalised codebook of the
    first quantizer, (|e|^2 - 2 e.c) + |c|^2."""
    w = wn_weight(P, "quantizer.layers.0.in_proj")
    e = _normalize(latents.T @ w.T + P["quantizer.layers.0.in_proj.b"])
    c = _normalize(P["quantizer.layers.0.codebook"])
    return (torch.sum(e * e, dim=1, keepdim=True) - 2.0 * (e @ c.T)
            + torch.sum(c * c, dim=1)[None, :])


def code_gaps(dist, codes):
    """dist (F, N) of the reference, codes (F,) to judge -> (F,) how far
    each code's distance lies above the reference's nearest code's."""
    best = dist.min(dim=1).values
    return dist.gather(1, codes.long()[:, None])[:, 0] - best


def hann(n, device):
    """The periodic Hann window, computed in float64, as fp32."""
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)
    return torch.tensor(w, dtype=torch.float32, device=device)
