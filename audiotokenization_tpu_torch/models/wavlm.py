"""WavLM, the SSL upstream the speaker-verification suite taps for
layer-weighted features (counterpart of ``audiotokenization_tpu/models/
wavlm.py``; the architecture of transformers' ``modeling_wavlm.py``):

  raw wav (B, T)
  -> conv feature encoder (7 conv1d stages, stride 320 in all; a
     channel-wise GroupNorm after conv 0 in 'group' mode (base), a
     LayerNorm after every conv in 'layer' mode (large)), exact GELU
  -> feature projection (LayerNorm + Linear)
  -> conv positional embedding (k 128, 16 groups, its dim-2 weight norm
     folded, padding 64, the trailing column trimmed for an even kernel,
     GELU) added to the stream
  -> N transformer layers with a GATED RELATIVE POSITION BIAS: T5-style
     log-spaced buckets (320 buckets, max distance 800) embedded per head
     by layer 0 and shared down the stack, gated per (head, query) by each
     layer's own hidden states
  -> the hidden states (each layer's input, and the last output), the
     s3prl surface that ``models/ecapa_tdnn.py::ssl_weighted_features``
     weights.

Post-LN ('group', base: ``encoder_ln`` before the layers) and stable pre-LN
('layer', large: ``encoder_ln`` on the last hidden state only).

``SslEncoder`` holds the parameters of this encoder and of the bias-free
wav2vec2 / HuBERT / UniSpeech-SAT one (``models/wav2vec2.py``) under the
JAX tree's names (``conv_layers.0.gn.g``, ``layers.3.attn.q.w``, ...);
``convert_wavlm`` maps a transformers state dict onto them, and
``load_ssl_model`` builds the model from it. The buckets are computed in
numpy float64, as the JAX package computes them at trace time (a float32
log would move positions across bucket boundaries), and cached per (T,
device). Attention is ``ops/transformer.py::attend`` with the gated table
as its additive bias: fp32 with TF32 off takes its blocked plain path.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import Weights, conv1d, linear
from ..ops.transformer import attend, layer_norm


@dataclasses.dataclass
class WavLMConfig:
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    feat_extract_norm: str = "group"  # "group" (base) | "layer" (large)
    conv_bias: bool = False
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    num_buckets: int = 320
    max_bucket_distance: int = 800
    do_stable_layer_norm: bool = False  # True for wavlm-large
    layer_norm_eps: float = 1e-5


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class Norm(nn.Module):
    """A LayerNorm's or GroupNorm's ``g`` and ``b``, the JAX tree's names."""

    def __init__(self, c: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(c))
        self.b = nn.Parameter(torch.zeros(c))


def _lin(n_out: int, n_in: int) -> Weights:
    return Weights(torch.zeros(n_out, n_in), torch.zeros(n_out))


class _ConvLayer(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, bias: bool, norm: str | None):
        super().__init__()
        self.conv = Weights(torch.zeros(cout, cin, k), torch.zeros(cout) if bias else None)
        if norm is not None:
            self.add_module(norm, Norm(cout))


class _Attention(nn.Module):
    def __init__(self, c: int, heads: int, gated: bool):
        super().__init__()
        self.q, self.k, self.v, self.out = (_lin(c, c) for _ in range(4))
        if gated:
            self.gru_rel_pos_linear = _lin(8, c // heads)
            self.gru_rel_pos_const = nn.Parameter(torch.ones(heads))


class _FFN(nn.Module):
    def __init__(self, c: int, inter: int):
        super().__init__()
        self.add_module("in", _lin(inter, c))
        self.out = _lin(c, inter)


class _Layer(nn.Module):
    def __init__(self, cfg, gated: bool):
        super().__init__()
        c = cfg.hidden_size
        self.attn = _Attention(c, cfg.num_attention_heads, gated)
        self.ffn = _FFN(c, cfg.intermediate_size)
        self.ln1, self.ln2 = Norm(c), Norm(c)


class SslEncoder(nn.Module):
    """The wav2vec2-family encoder's parameters; ``gated`` (WavLM) adds the
    gate projections and the shared ``rel_attn_embed`` (num_buckets, H).
    ``cfg`` and ``gated`` ride along."""

    def __init__(self, cfg, *, gated: bool):
        super().__init__()
        self.cfg, self.gated = cfg, gated
        layers, cin = [], 1
        for i, (cout, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
            norm = ("ln" if cfg.feat_extract_norm == "layer"
                    else "gn" if i == 0 else None)
            layers.append(_ConvLayer(cin, cout, k, cfg.conv_bias, norm))
            cin = cout
        self.conv_layers = nn.ModuleList(layers)
        c = cfg.hidden_size
        self.feat_proj_ln = Norm(cin)
        self.feat_proj = _lin(c, cin)
        self.pos_conv = Weights(
            torch.zeros(c, c // cfg.num_conv_pos_embedding_groups, cfg.num_conv_pos_embeddings),
            torch.zeros(c))
        self.encoder_ln = Norm(c)
        self.layers = nn.ModuleList(_Layer(cfg, gated) for _ in range(cfg.num_hidden_layers))
        if gated:
            self.rel_attn_embed = nn.Parameter(torch.zeros(cfg.num_buckets,
                                                           cfg.num_attention_heads))


def load_ssl_model(tensors: Mapping[str, torch.Tensor], cfg, *, gated: bool,
                   device="cuda") -> SslEncoder:
    """An ``SslEncoder`` of ``cfg`` holding ``tensors`` (``convert_wavlm``'s
    output), frozen, in eval mode on ``device`` (raises without a card
    unless ``device="cpu"``)."""
    from .codec import resolve_device

    device = resolve_device(device)
    with torch.device("meta"):
        model = SslEncoder(cfg, gated=gated)
    model.load_state_dict(tensors, assign=True)
    return model.requires_grad_(False).eval().to(device)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _ln(x, p: Norm, eps: float):
    return layer_norm(x, p.g, p.b, eps=eps)


def feature_encoder(model: SslEncoder, wav):
    """wav (B, T) -> (B, C, T / 320)."""
    cfg = model.cfg
    x = wav[:, None, :]
    for i, layer in enumerate(model.conv_layers):
        x = conv1d(x, layer.conv.w, layer.conv._parameters.get("b"), stride=cfg.conv_stride[i])
        if hasattr(layer, "gn"):  # GroupNorm(groups = C): per-channel stats over T
            mu = x.mean(-1, keepdim=True)
            var = x.var(-1, keepdim=True, correction=0)
            x = (x - mu) * torch.rsqrt(var + 1e-5) * layer.gn.g[None, :, None] \
                + layer.gn.b[None, :, None]
        elif hasattr(layer, "ln"):
            x = _ln(x.transpose(1, 2), layer.ln, 1e-5).transpose(1, 2)
        x = F.gelu(x)
    return x


def _pos_conv_embed(model: SslEncoder, h):
    """h (B, T, C) -> the positional embedding (B, T, C)."""
    cfg = model.cfg
    k = cfg.num_conv_pos_embeddings
    x = conv1d(h.transpose(1, 2), model.pos_conv.w, model.pos_conv.b, padding=k // 2,
               groups=cfg.num_conv_pos_embedding_groups)
    if k % 2 == 0:
        x = x[:, :, :-1]
    return F.gelu(x).transpose(1, 2)


def _relative_buckets(rel_pos, *, num_buckets: int, max_distance: int):
    """T5-style signed log-spaced buckets of integer offsets (numpy, the log
    in float64)."""
    nb = num_buckets // 2
    buckets = (rel_pos > 0).astype(np.int64) * nb
    rel = np.abs(rel_pos)
    max_exact = nb // 2
    large = (max_exact
             + (np.log(np.maximum(rel, 1).astype(np.float64) / max_exact)
                / math.log(max_distance / max_exact) * (nb - max_exact))).astype(np.int64)
    large = np.minimum(large, nb - 1)
    return buckets + np.where(rel < max_exact, rel, large)


@functools.lru_cache(maxsize=32)
def _bucket_index(T: int, num_buckets: int, max_distance: int,
                  device: torch.device) -> torch.Tensor:
    pos = np.arange(T)
    b = _relative_buckets(pos[None, :] - pos[:, None], num_buckets=num_buckets,
                          max_distance=max_distance)
    return torch.from_numpy(b).to(device)


def _position_bias(model: SslEncoder, T: int):
    """The shared ungated bias table (H, T, T)."""
    cfg = model.cfg
    idx = _bucket_index(T, cfg.num_buckets, cfg.max_bucket_distance, model.rel_attn_embed.device)
    return model.rel_attn_embed[idx].permute(2, 0, 1)


def _attention(p: _Attention, x, heads: int, pos_bias=None):
    """Multi-head attention, x (B, T, C); with ``pos_bias`` (H, T, T), the
    WavLM gate: sigmoid of the head's hidden states projected to 8 and
    summed in pairs of 4, gate = a·(b·const - 1) + 2, times the table."""
    B, T, C = x.shape
    D = C // heads
    bias = None
    if pos_bias is not None:
        proj = linear(x.reshape(B, T, heads, D).transpose(1, 2), p.gru_rel_pos_linear)
        gate_a, gate_b = torch.sigmoid(proj.reshape(B, heads, T, 2, 4).sum(-1)).chunk(2, dim=-1)
        gate = gate_a * (gate_b * p.gru_rel_pos_const.reshape(1, heads, 1, 1) - 1.0) + 2.0
        bias = gate * pos_bias[None]
    q, k, v = (linear(x, w).reshape(B, T, heads, D) for w in (p.q, p.k, p.v))
    return linear(attend(q, k, v, bias).reshape(B, T, C), p.out)


def _feed_forward(p: _FFN, x):
    return linear(F.gelu(linear(x, getattr(p, "in"))), p.out)


def encoder_apply(model: SslEncoder, wav, *, output_layer: int | None = None):
    """wav (B, T) -> the list of hidden states [(B, T', C)] * (L + 1), or
    only hidden_states[output_layer] (0: the encoder's input), computing
    no layer past it."""
    cfg = model.cfg
    eps = cfg.layer_norm_eps
    heads = cfg.num_attention_heads
    x = _ln(feature_encoder(model, wav).transpose(1, 2), model.feat_proj_ln, eps)
    h = linear(x, model.feat_proj)
    h = h + _pos_conv_embed(model, h)
    if not cfg.do_stable_layer_norm:
        h = _ln(h, model.encoder_ln, eps)
    pos_bias = _position_bias(model, h.shape[1]) if model.gated else None
    hiddens = [h]
    n = len(model.layers) if output_layer is None else min(output_layer, len(model.layers))
    for lp in model.layers[:n]:
        if cfg.do_stable_layer_norm:  # pre-LN (large)
            h = h + _attention(lp.attn, _ln(h, lp.ln1, eps), heads, pos_bias)
            h = h + _feed_forward(lp.ffn, _ln(h, lp.ln2, eps))
        else:  # post-LN (base)
            h = _ln(h + _attention(lp.attn, h, heads, pos_bias), lp.ln1, eps)
            h = _ln(h + _feed_forward(lp.ffn, h), lp.ln2, eps)
        hiddens.append(h)
    if cfg.do_stable_layer_norm and n == len(model.layers):
        hiddens[-1] = _ln(hiddens[-1], model.encoder_ln, eps)
    return hiddens if output_layer is None else hiddens[output_layer]


def wavlm_apply(model: SslEncoder, wav, *, output_layer: int | None = None):
    """WavLM's hidden states of wav (B, T) (``encoder_apply``)."""
    if not model.gated:
        raise ValueError("wavlm_apply needs a WavLM model (gated relative position bias)")
    return encoder_apply(model, wav, output_layer=output_layer)


def make_ssl_fn(model: SslEncoder):
    """``ssl_fn`` for ``models/ecapa_tdnn.py::extract_features(feat_type=
    'ssl')``: wav (B, T) -> the hidden states. The model is ``fn.model``."""
    def fn(wav):
        return encoder_apply(model, wav)

    fn.model = model
    return fn


# ---------------------------------------------------------------------------
# transformers state dicts (WavLMModel layout)
# ---------------------------------------------------------------------------

def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def convert_wavlm(sd: Mapping[str, Any], cfg, *, _family: str = "wavlm") -> dict[str, torch.Tensor]:
    """A transformers ``WavLMModel`` state dict (tensors or numpy arrays) ->
    ``SslEncoder``'s state dict (CPU tensors, copied). The pos conv's dim-2
    weight norm (``parametrizations.weight.original0/1`` or ``weight_g`` /
    ``weight_v``) is folded in numpy, as the JAX package folds it.
    ``_family="wav2vec2"``: the bias-free layout of Wav2Vec2Model /
    HubertModel / UniSpeechSatModel (``models/wav2vec2.py``)."""
    out: dict[str, torch.Tensor] = {}

    def t(k):
        return torch.from_numpy(np.array(_numpy(sd[k]), copy=True))

    def lin(ours, theirs):
        out[f"{ours}.w"], out[f"{ours}.b"] = t(theirs + ".weight"), t(theirs + ".bias")

    def ln(ours, theirs):
        out[f"{ours}.g"], out[f"{ours}.b"] = t(theirs + ".weight"), t(theirs + ".bias")

    for i in range(len(cfg.conv_dim)):
        pre = f"feature_extractor.conv_layers.{i}"
        out[f"conv_layers.{i}.conv.w"] = t(f"{pre}.conv.weight")
        if f"{pre}.conv.bias" in sd:
            out[f"conv_layers.{i}.conv.b"] = t(f"{pre}.conv.bias")
        if f"{pre}.layer_norm.weight" in sd:
            key = "gn" if (cfg.feat_extract_norm == "group" and i == 0) else "ln"
            ln(f"conv_layers.{i}.{key}", f"{pre}.layer_norm")

    pc = "encoder.pos_conv_embed.conv"
    if f"{pc}.parametrizations.weight.original0" in sd:
        g = _numpy(sd[f"{pc}.parametrizations.weight.original0"])
        v = _numpy(sd[f"{pc}.parametrizations.weight.original1"])
    else:
        g, v = _numpy(sd[f"{pc}.weight_g"]), _numpy(sd[f"{pc}.weight_v"])
    norm = np.sqrt(np.sum(v * v, axis=(0, 1), keepdims=True))
    out["pos_conv.w"] = torch.from_numpy(np.array(g * v / np.maximum(norm, 1e-12)))
    out["pos_conv.b"] = t(f"{pc}.bias")

    ln("feat_proj_ln", "feature_projection.layer_norm")
    lin("feat_proj", "feature_projection.projection")
    ln("encoder_ln", "encoder.layer_norm")
    for i in range(cfg.num_hidden_layers):
        pre, ours = f"encoder.layers.{i}", f"layers.{i}"
        for name, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                             ("out", "out_proj")):
            lin(f"{ours}.attn.{name}", f"{pre}.attention.{theirs}")
        if _family == "wavlm":
            lin(f"{ours}.attn.gru_rel_pos_linear", f"{pre}.attention.gru_rel_pos_linear")
            out[f"{ours}.attn.gru_rel_pos_const"] = t(
                f"{pre}.attention.gru_rel_pos_const").reshape(-1)
        lin(f"{ours}.ffn.in", f"{pre}.feed_forward.intermediate_dense")
        lin(f"{ours}.ffn.out", f"{pre}.feed_forward.output_dense")
        ln(f"{ours}.ln1", f"{pre}.layer_norm")
        ln(f"{ours}.ln2", f"{pre}.final_layer_norm")
    if _family == "wavlm":
        out["rel_attn_embed"] = t("encoder.layers.0.attention.rel_attn_embed.weight")
    return out
