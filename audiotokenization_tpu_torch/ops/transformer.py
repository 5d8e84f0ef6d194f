"""Conformer building blocks (counterpart of
``audiotokenization_tpu/ops/transformer.py``, the dense layers).

- ``rms_norm``: fp32 RMS norm over the last dim (eps 1e-6), cast back, then
  the weight; ``layer_norm``: LayerNorm with the biased variance;
- RoPE: ``precompute_rope`` builds the cos/sin tables in float64 (stored
  fp32), ``apply_rope`` rotates the interleaved pairs (x[2i], x[2i+1]) in
  fp32 — not the half-split ``rotate_half`` of most PyTorch code;
- ``self_attention``: fused qkv projection (rows [q heads | k heads | v
  heads]), a weightless RMS norm on q and k, RoPE, then ``attend``;
- ``feed_forward``: SwiGLU, w2(silu(w1 x) · w3 x), hidden width
  ``swiglu_hidden_dim`` (768 at dim 256);
- ``conformer_conv_module``: pw1 -> GLU -> depthwise k conv ('same', or
  causal) -> RMS norm -> SiLU -> pw2;
- ``conformer_layer``: pre-norm {conv | attn, ffn1, attn | conv, ffn2}
  with plain residual adds, ``conv_first`` selecting the order;
- ``conformer_backbone``: the layers with one RoPE table sliced to T.

The backbone runs time-major, (B, T, C), where the JAX package's layer
boundary is (B, C, T): every op but the depthwise conv works on the last
dim, so the layout changes nothing but where the transposes are. The
k=1 convs are the linear layers they are (``ops/conv.py::pointwise``).

Ragged batches pass ``valid`` (B,) frame counts: attention masks the pad
keys and the conv module zeroes the pad frames before its depthwise conv,
so each sample computes what it computes alone.

Attention precision: fp32 inputs with TF32 off (the conformant path) take
plain fp32 ops, softmax(q kᵀ · D^-½ + bias) v, with the value sum blocked
by ``KEY_BLOCK`` keys, each block's product added into the output. One
fp32 GEMM over the whole key axis, which SDPA's math backend runs, is
summed by cuBLAS in one chain: at 2,400 keys (30 s of audio) its error
against float64 is several times the CPU's on the H100, over the
precision rule's 4x; blocked, it is about the CPU's (PERF.md). Otherwise
(TF32 allowed, bf16) SDPA runs and PyTorch picks its backend. A masked
logit is -0.7 x the dtype's max, as in ``jax.nn.dot_product_attention``:
a query that sees no key gets the mean of the values, finite, where a
boolean SDPA mask gives NaN.

An FFN built as ``ops/moe.py::MoEFeedForward`` (``ffn_type: moe``) runs
as a GShard MoE with the backbone's (``moe_top_k``,
``moe_capacity_factor``), pad frames under ``valid`` claiming no expert
slot; ``conformer_layer`` / ``conformer_backbone`` append each MoE layer's
aux losses to the ``aux`` list a caller passes (the JAX package collects
them through a thread-local context instead). Remat and the
tensor/pipeline parallel hooks are not ported.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .conv import causal_conv1d, conv1d, get_weight, init_conv1d, init_linear, linear, pointwise
from .moe import MoEFeedForward, moe_ffn

_MASKED = -0.7  # x finfo(dtype).max: a masked logit, as jax.nn.dot_product_attention's
KEY_BLOCK = 128  # keys per partial value sum of the fp32 attention


def rms_norm(x, weight=None, *, eps: float = 1e-6):
    """RMS norm over the last dim in fp32, cast back to x's dtype, times
    ``weight``."""
    xf = x.float()
    normed = (xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)).to(x.dtype)
    return normed if weight is None else normed * weight


def layer_norm(x, gain, bias, *, eps: float = 1e-5):
    """torch nn.LayerNorm over the last dim: the biased (population)
    variance, then ``gain`` and ``bias``. The SSL upstreams' norm
    (``models/wavlm.py``, ``models/wav2vec2.py``)."""
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps) * gain + bias


@functools.lru_cache(maxsize=16)
def precompute_rope(head_dim: int, max_len: int, theta: float,
                    device: torch.device = torch.device("cpu")):
    """cos/sin tables (max_len, head_dim // 2), fp32, computed in float64;
    cached per device (treat them as read-only)."""
    freqs = 1.0 / (theta ** (np.arange(0, head_dim, 2)[: head_dim // 2] / head_dim))
    ang = np.outer(np.arange(max_len, dtype=np.float64), freqs)
    return (torch.tensor(np.cos(ang), dtype=torch.float32, device=device),
            torch.tensor(np.sin(ang), dtype=torch.float32, device=device))


def apply_rope(x, cos, sin):
    """x (B, T, H, D); pairs (x[2i], x[2i+1]) rotated by the angles of
    cos/sin (T, D / 2), in fp32, cast back."""
    xf = x.float()
    xe, xo = xf[..., 0::2], xf[..., 1::2]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.stack([xe * c - xo * s, xe * s + xo * c], dim=-1).reshape(x.shape).to(x.dtype)


def frame_mask(valid, T: int):
    """(B,) frame counts -> (B, T) bool, True on each sample's frames."""
    return torch.arange(T, device=valid.device)[None, :] < valid[:, None]


def masked_bias(allowed, dtype):
    """Additive attention mask from a bool ``allowed`` (True: the query
    sees the key): 0, or -0.7 x the dtype's max."""
    return torch.zeros(allowed.shape, dtype=dtype, device=allowed.device).masked_fill(
        ~allowed, _MASKED * torch.finfo(dtype).max)


def attention_bias(T: int, *, valid=None, causal: bool = False, dtype, device):
    """The backbone's additive mask (B | 1, 1, T, T) for ``valid`` (pad keys
    masked) and ``causal``; None when there are no pad keys (a causal
    attention then passes ``is_causal``)."""
    if valid is None:
        return None
    allowed = frame_mask(valid, T)[:, None, None, :]
    if causal:
        allowed = allowed & torch.ones(T, T, dtype=torch.bool, device=device).tril()
    return masked_bias(allowed, dtype)


def plain_fp32(dtype) -> bool:
    """Whether ``attend`` takes its plain fp32 path for ``dtype`` under the
    current TF32 flag (fp32 with TF32 off), rather than SDPA."""
    return dtype == torch.float32 and not torch.backends.cuda.matmul.allow_tf32


def _attend_fp32(q, k, v, bias, causal: bool):
    """``attend`` in plain fp32 ops, heads first (B, H, T, D), the value sum
    blocked by KEY_BLOCK keys (module docstring): each block one GEMM on a
    strided view of the probabilities, added into the output."""
    s = (q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    if bias is None and causal:
        bias = masked_bias(torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device).tril(),
                           s.dtype)
    p = torch.softmax(s if bias is None else s + bias, dim=-1)
    B, H, Tq, Tk = p.shape
    p, v = p.reshape(B * H, Tq, Tk), v.reshape(B * H, Tk, -1)
    out = p[:, :, :KEY_BLOCK] @ v[:, :KEY_BLOCK]
    for j in range(KEY_BLOCK, Tk, KEY_BLOCK):
        out.baddbmm_(p[:, :, j:j + KEY_BLOCK], v[:, j:j + KEY_BLOCK])
    return out.reshape(B, H, Tq, -1)


def attend(q, k, v, bias=None, *, causal: bool = False):
    """softmax(q kᵀ / √D + bias) v for q (B, Tq, H, D) and k, v (B, Tk, H, D)
    -> (B, Tq, H, D); ``causal`` (without a bias) masks the upper triangle.
    fp32 with TF32 off: plain blocked ops; otherwise SDPA (module
    docstring)."""
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    if plain_fp32(q.dtype):
        out = _attend_fp32(q, k, v, bias, causal)
    else:
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                             is_causal=causal and bias is None)
    return out.transpose(1, 2)


class Attention(nn.Module):
    """``qkv`` (3C, C) and ``out`` (C, C), no biases."""

    def __init__(self, dim: int, *, generator: torch.Generator):
        super().__init__()
        self.qkv = init_linear(dim, 3 * dim, bias=False, generator=generator)
        self.out = init_linear(dim, dim, bias=False, generator=generator)


def qkv_heads(x, p: Attention, cos, sin, n_head: int):
    """x (B, T, C) -> q, k, v (B, T, H, D): q and k RMS-normed (no weight)
    and rotated."""
    B, T, C = x.shape
    q, k, v = linear(x, p.qkv).reshape(B, T, 3, n_head, C // n_head).unbind(2)
    return apply_rope(rms_norm(q), cos, sin), apply_rope(rms_norm(k), cos, sin), v


def self_attention(x, p: Attention, cos, sin, *, n_head: int, bias=None,
                   causal: bool = False):
    """x (B, T, C) -> (B, T, C); ``bias`` from ``attention_bias``."""
    B, T, C = x.shape
    q, k, v = qkv_heads(x, p, cos, sin, n_head)
    return linear(attend(q, k, v, bias, causal=causal).reshape(B, T, C), p.out)


def swiglu_hidden_dim(dim: int, mult: int = 4) -> int:
    """2/3 of mult·dim, rounded up to a multiple of 256."""
    return 256 * -(-int(2 * dim * mult / 3) // 256)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4, *, generator: torch.Generator):
        super().__init__()
        hidden = swiglu_hidden_dim(dim, mult)
        self.w1 = init_linear(dim, hidden, bias=False, generator=generator)
        self.w2 = init_linear(hidden, dim, bias=False, generator=generator)
        self.w3 = init_linear(dim, hidden, bias=False, generator=generator)


def feed_forward(x, p: FeedForward):
    """SwiGLU: w2(silu(w1 x) · w3 x), x (..., C)."""
    return linear(F.silu(linear(x, p.w1)) * linear(x, p.w3), p.w2)


class ConformerConvModule(nn.Module):
    def __init__(self, dim: int, kernel_size: int = 31, *, generator: torch.Generator):
        super().__init__()
        self.pw1 = init_conv1d(dim, 2 * dim, 1, generator=generator)
        self.dw = init_conv1d(dim, dim, kernel_size, groups=dim, generator=generator)
        self.pw2 = init_conv1d(dim, dim, 1, generator=generator)
        self.norm = nn.Parameter(torch.ones(dim))


def conv_module(x, p: ConformerConvModule, depthwise, keep=None):
    """pw1 -> GLU -> (× ``keep`` (B, T)) -> ``depthwise`` (a function of the
    (B, C, T) GLU output, giving (B, C, T)) -> RMS norm -> SiLU -> pw2.
    x (B, T, C) -> (B, T, C)."""
    a, b = pointwise(x, p.pw1).chunk(2, dim=-1)
    out = a * torch.sigmoid(b)
    if keep is not None:
        out = out * keep[:, :, None].to(out.dtype)
    out = depthwise(out.transpose(1, 2)).transpose(1, 2)
    return pointwise(F.silu(rms_norm(out, p.norm)), p.pw2)


def conformer_conv_module(x, p: ConformerConvModule, *, causal: bool = False, valid=None):
    """The conv module over x (B, T, C); ``valid`` zeroes each sample's pad
    frames before the depthwise conv, which then reads the zero padding a
    file of that length has at its edge."""
    w, b = get_weight(p.dw), p.dw.b
    k, groups = w.shape[-1], w.shape[0]
    if causal:
        depthwise = lambda y: causal_conv1d(y, w, b, groups=groups)  # noqa: E731
    else:
        depthwise = lambda y: conv1d(y, w, b, padding=(k - 1) // 2, groups=groups)  # noqa: E731
    return conv_module(x, p, depthwise, None if valid is None else frame_mask(valid, x.shape[1]))


class ConformerLayer(nn.Module):
    """``ffn_type``: ``dense`` (SwiGLU) or ``moe`` (``moe_experts`` experts)."""

    def __init__(self, dim: int, *, n_head: int, ffn_mult: int = 4, conv_kernel_size: int = 31,
                 ffn_type: str = "dense", moe_experts: int = 4, generator: torch.Generator):
        super().__init__()
        if ffn_type not in ("dense", "moe"):
            raise ValueError(f"unknown ffn_type {ffn_type!r}")

        def ffn():
            if ffn_type == "moe":
                return MoEFeedForward(dim, n_experts=moe_experts, ffn_mult=ffn_mult,
                                      generator=generator)
            return FeedForward(dim, ffn_mult, generator=generator)

        self.ffn1 = ffn()
        self.ffn2 = ffn()
        self.attn = Attention(dim, generator=generator)
        self.conv = ConformerConvModule(dim, conv_kernel_size, generator=generator)
        for name in ("attn_norm", "conv_norm", "ffn1_norm", "ffn2_norm"):
            setattr(self, name, nn.Parameter(torch.ones(dim)))


def conformer_layer(x, p: ConformerLayer, cos, sin, *, n_head: int, conv_first: bool = False,
                    causal: bool = False, valid=None, bias=None, moe_args=(2, 1.25), aux=None):
    """Pre-norm {conv | attn, ffn1, attn | conv, ffn2} over x (B, T, C), plain
    residual adds. ``bias``: ``attention_bias`` of ``valid`` and ``causal``
    (computed here when not given). An MoE FFN routes with ``moe_args`` =
    (top_k, capacity_factor), ``valid``'s pad frames masked, and appends its
    aux losses to ``aux`` when that is a list."""
    if bias is None and valid is not None:
        bias = attention_bias(x.shape[1], valid=valid, causal=causal, dtype=x.dtype,
                              device=x.device)

    def attn(x):
        return x + self_attention(rms_norm(x, p.attn_norm), p.attn, cos, sin, n_head=n_head,
                                  bias=bias, causal=causal)

    def conv(x):
        return x + conformer_conv_module(rms_norm(x, p.conv_norm), p.conv, causal=causal,
                                         valid=valid)

    def ffn(x, fp, w):
        y = rms_norm(x, w)
        if not isinstance(fp, MoEFeedForward):
            return x + feed_forward(y, fp)
        mask = None if valid is None else frame_mask(valid, y.shape[1])
        out, layer_aux = moe_ffn(y, fp, top_k=int(moe_args[0]),
                                 capacity_factor=float(moe_args[1]), token_mask=mask,
                                 losses=aux is not None)
        if aux is not None:
            aux.append(layer_aux)
        return x + out

    x = conv(x) if conv_first else attn(x)
    x = ffn(x, p.ffn1, p.ffn1_norm)
    x = attn(x) if conv_first else conv(x)
    return ffn(x, p.ffn2, p.ffn2_norm)


class ConformerBackbone(nn.Module):
    """``layers`` of one width; the settings the layers run with ride along."""

    def __init__(self, dim: int, n_layers: int, *, n_head: int, ffn_mult: int = 4,
                 conv_kernel_size: int = 31, rope_theta: float = 10000.0,
                 max_seq_len: int = 8192, conv_first: bool = False, causal: bool = False,
                 ffn_type: str = "dense", moe_experts: int = 4, moe_top_k: int = 2,
                 moe_capacity_factor: float = 1.25, generator: torch.Generator):
        super().__init__()
        self.dim, self.n_head = dim, n_head
        self.rope_theta, self.max_seq_len = rope_theta, max_seq_len
        self.conv_first, self.causal = conv_first, causal
        self.moe_args = (moe_top_k, moe_capacity_factor)
        self.layers = nn.ModuleList(
            ConformerLayer(dim, n_head=n_head, ffn_mult=ffn_mult,
                           conv_kernel_size=conv_kernel_size, ffn_type=ffn_type,
                           moe_experts=moe_experts, generator=generator)
            for _ in range(n_layers))

    def rope(self, device):
        """The RoPE tables of all ``max_seq_len`` positions on ``device``."""
        return precompute_rope(self.dim // self.n_head, self.max_seq_len, float(self.rope_theta),
                               torch.device(device))


def conformer_backbone(x, p: ConformerBackbone, *, valid=None, aux=None):
    """x (B, T, C) through every layer; T at most ``max_seq_len`` (the RoPE
    table's length). ``aux``: a list that each MoE FFN's aux losses are
    appended to."""
    T = x.shape[1]
    if T > p.max_seq_len:
        raise ValueError(f"{T} frames exceed max_seq_len={p.max_seq_len} (the RoPE table)")
    cos, sin = (t[:T] for t in p.rope(x.device))
    bias = (None if valid is None else
            attention_bias(T, valid=valid, causal=p.causal, dtype=x.dtype, device=x.device))
    for layer in p.layers:
        x = conformer_layer(x, layer, cos, sin, n_head=p.n_head, conv_first=p.conv_first,
                            causal=p.causal, valid=valid, bias=bias, moe_args=p.moe_args,
                            aux=aux)
    return x
