"""1-D convolutions (and the discriminators' 2-D one), weight normalisation,
linear layers and their initialisers.

Counterpart of ``audiotokenization_tpu/ops/conv.py``. Layouts are the JAX
package's, which are PyTorch's: activations (B, C, T), conv weights
(O, I/groups, K), transpose-conv weights (I, O/groups, K), linear weights
(out, in). The convolutions are ``F.conv1d`` / ``F.conv_transpose1d``: the
JAX package left them to XLA, and on the card they go to cuDNN. The causal
pair (``causal_conv1d``, ``causal_conv_transpose1d``) is the reference's
streaming form: left padding only, and a transpose conv trimmed on the
right.

Weight norm is kept as the ``{v, g}`` pair the JAX tree and torch's
``weight_norm`` use (w = g·v/‖v‖, norm over every dim but 0);
``fold_weight_norm`` turns each pair into one ``w`` for inference.
"""
from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.fsdp import remember


def conv1d(x, w, b=None, *, stride: int = 1, padding: int = 0, dilation: int = 1,
           groups: int = 1):
    """Cross-correlation with symmetric zero padding; k=1 is the pointwise
    conv, a channel matmul."""
    return F.conv1d(x, w, b, stride=stride, padding=padding, dilation=dilation,
                    groups=groups)


def conv2d(x, p, *, stride=(1, 1), padding=(0, 0)):
    """NCHW cross-correlation with the effective weight (O, I, kh, kw) and
    bias of ``p``, symmetric zero padding (the discriminators' conv)."""
    return F.conv2d(x, get_weight(p), _tensors(p).get("b"), stride=stride, padding=padding)


def conv_transpose1d(x, w, b=None, *, stride: int = 1, padding: int = 0,
                     output_padding: int = 0, dilation: int = 1, groups: int = 1):
    """nn.ConvTranspose1d semantics. Output length
    (T - 1)·stride - 2·padding + dilation·(K - 1) + output_padding + 1."""
    return F.conv_transpose1d(x, w, b, stride=stride, padding=padding,
                              output_padding=output_padding, groups=groups,
                              dilation=dilation)


def causal_conv1d(x, w, b=None, *, stride: int = 1, dilation: int = 1, groups: int = 1):
    """Streaming-causal conv: left padding (K - stride)·dilation, none on
    the right (the reference's CausalConv1d)."""
    x = F.pad(x, ((w.shape[-1] - stride) * dilation, 0))
    return conv1d(x, w, b, stride=stride, dilation=dilation, groups=groups)


def causal_conv_transpose1d(x, w, b=None, *, stride: int = 1):
    """Causal transpose conv: the plain transpose conv with its last
    ``stride`` samples trimmed (the reference's CausalConvTranspose1d)."""
    return conv_transpose1d(x, w, b, stride=stride)[..., :-stride]


# ---------------------------------------------------------------------------
# Weight normalisation
# ---------------------------------------------------------------------------

def _norm_except_dim0(v):
    return torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.ndim)), keepdim=True))


def weight_norm(v, g):
    """w = g · v / ‖v‖; g shaped (O, 1, ...) like torch weight_norm's ``weight_g``."""
    return v * (g / _norm_except_dim0(v))


def _tensors(p) -> Mapping:
    return p._parameters if isinstance(p, nn.Module) else p


def get_weight(p):
    """Effective weight of a conv/linear: its folded ``w``, or g·v/‖v‖
    (inside an FSDP block, recomputed in the backward rather than kept:
    ``parallel/fsdp.py::remember``). ``p`` is a dict of tensors or a
    ``WeightNormed`` module."""
    t = _tensors(p)
    if "w" in t:
        return t["w"]
    v, g = t["v"], t["g"]
    return remember(weight_norm(v, g), weight_norm, v, g)


class WeightNormed(nn.Module):
    """The parameters of one weight-normed conv or linear layer: ``v``, ``g``
    and the bias ``b``, named as in the JAX tree."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.v = nn.Parameter(w)
        self.g = nn.Parameter(_norm_except_dim0(w))
        self.b = nn.Parameter(b)

    def weight(self):
        return get_weight(self)


class Weights(nn.Module):
    """The parameters of one conv or linear layer without weight norm: ``w``
    and, with a bias, ``b``, named as in the JAX tree."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor | None = None):
        super().__init__()
        self.w = nn.Parameter(w)
        if b is not None:
            self.b = nn.Parameter(b)


def fold_weight_norm(params):
    """Fold every ``{v, g}`` pair into one weight ``w``.

    An ``nn.Module`` is folded in place and returned; a nested dict/list
    tree (the JAX tree's structure) is returned as a new tree.
    """
    if isinstance(params, nn.Module):
        with torch.no_grad():
            for m in params.modules():
                if "v" in m._parameters and "g" in m._parameters:
                    w = weight_norm(m.v, m.g)
                    del m.v, m.g
                    m.w = nn.Parameter(w)
        return params
    if isinstance(params, dict):
        if {"v", "g"} <= params.keys():
            rest = {k: fold_weight_norm(val) for k, val in params.items()
                    if k not in ("v", "g")}
            return {"w": weight_norm(params["v"], params["g"]), **rest}
        return {k: fold_weight_norm(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(fold_weight_norm(v) for v in params)
    return params


def linear(x, p):
    """F.linear with the effective weight of ``p``: x @ w.T + b, w (out, in)."""
    return F.linear(x, get_weight(p), _tensors(p).get("b"))


def pointwise(x, p):
    """A k=1 conv (weight (out, in, 1)) over time-major x (..., in): the
    linear layer it is."""
    return F.linear(x, get_weight(p)[..., 0], _tensors(p).get("b"))


# ---------------------------------------------------------------------------
# Initialisers: torch's defaults, drawn from an explicit generator
# ---------------------------------------------------------------------------

def kaiming_uniform_fan_in(shape, *, generator: torch.Generator):
    """torch's default conv/linear weight init, kaiming_uniform_(a=√5):
    U(-1/√fan_in, 1/√fan_in). A √3 error in this bound compounds over the
    codec's conv depth and NaNs the stack."""
    bound = 1.0 / math.sqrt(math.prod(shape[1:]))
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


def uniform_fan_in_bias(shape, fan_in: int, *, generator: torch.Generator):
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


def init_wn_conv1d(in_ch: int, out_ch: int, k: int, *,
                   generator: torch.Generator) -> WeightNormed:
    """A weight-normed conv as the reference codec effectively initialises
    it: kaiming-uniform v, g = ‖v‖, zero bias (bigcodec.py's module note)."""
    w = kaiming_uniform_fan_in((out_ch, in_ch, k), generator=generator)
    return WeightNormed(w, torch.zeros(out_ch))


def init_wn_conv_transpose1d(in_ch: int, out_ch: int, k: int, *,
                             generator: torch.Generator) -> WeightNormed:
    """Transpose conv, weight (in, out, K); torch's bias fan-in is out·K."""
    w = kaiming_uniform_fan_in((in_ch, out_ch, k), generator=generator)
    b = uniform_fan_in_bias((out_ch,), out_ch * k, generator=generator)
    return WeightNormed(w, b)


def init_wn_conv2d(in_ch: int, out_ch: int, kernel: tuple[int, int], *,
                   generator: torch.Generator) -> WeightNormed:
    """The discriminators' weight-normed conv: kaiming-uniform v (O, I, kh, kw),
    g = ‖v‖ (O, 1, 1, 1), torch's default bias, fan-in I·kh·kw."""
    w = kaiming_uniform_fan_in((out_ch, in_ch, *kernel), generator=generator)
    b = uniform_fan_in_bias((out_ch,), in_ch * kernel[0] * kernel[1], generator=generator)
    return WeightNormed(w, b)


def init_conv1d(in_ch: int, out_ch: int, k: int, *, groups: int = 1,
                generator: torch.Generator) -> Weights:
    """torch's default Conv1d: kaiming-uniform w (out, in / groups, k) and
    bias, fan-in (in / groups)·k."""
    w = kaiming_uniform_fan_in((out_ch, in_ch // groups, k), generator=generator)
    return Weights(w, uniform_fan_in_bias((out_ch,), in_ch // groups * k, generator=generator))


def init_linear(in_f: int, out_f: int, *, bias: bool = True,
                generator: torch.Generator) -> Weights:
    """torch's default Linear: kaiming-uniform w (out, in), bias fan-in in."""
    w = kaiming_uniform_fan_in((out_f, in_f), generator=generator)
    return Weights(w, uniform_fan_in_bias((out_f,), in_f, generator=generator) if bias else None)


def init_wn_linear(in_f: int, out_f: int, *,
                   generator: torch.Generator) -> WeightNormed:
    w = kaiming_uniform_fan_in((out_f, in_f), generator=generator)
    return WeightNormed(w, uniform_fan_in_bias((out_f,), in_f, generator=generator))
