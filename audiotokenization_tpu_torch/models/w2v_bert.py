"""The Wav2Vec2-BERT 2.0 encoder, the semantic branch's frozen teacher
(counterpart of ``audiotokenization_tpu/models/w2v_bert.py``).

The reference distils hidden layer 16 of the frozen HF
``Wav2Vec2BertModel("facebook/w2v-bert-2.0")``. The architecture
(SeamlessM4T's conformer encoder, ``position_embeddings_type='relative_key'``):

  feature projection: LayerNorm(160) -> Linear(-> hidden)
  24 conformer layers: half-step FFN1 -> self-attention with clamped
  relative-key distance embeddings (left 64 / right 8) -> GLU conv module
  (depthwise k 31, LEFT-padded) -> half-step FFN2 -> final LayerNorm

``W2vBert``'s state-dict keys are the JAX tree's paths (``feat_norm.w``,
``layers.<i>.attn.distance_embedding``, ...), so ``convert.params_from_jax``
maps a JAX teacher onto it unchanged; ``convert_w2v_bert`` maps an HF state
dict. Hidden-state indexing is HF's: hidden_states[i] is the output of
layer i - 1, so layer 16 is the output of encoder layer 15.

The attention's relative bias is q · Eᵀ (B, H, T, 73), gathered by the
clamped distance: the same D-long dot product per element as JAX's
``einsum`` over a gathered (T, T, D) table, without the table (576 MB a
layer at 30 s). fp32 with TF32 off takes ``ops/transformer.py``'s blocked
plain-fp32 attention with this bias; otherwise SDPA. ``valid_frames``
masks each row's pad keys, so each row's hidden states over its valid
frames equal its own forward (the conv module is left-padded, the rest per
position).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, fields
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import Weights, conv1d, linear
from ..ops.transformer import attend, masked_bias


@dataclass
class W2vBertConfig:
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    feature_projection_input_dim: int = 160
    left_max_position_embeddings: int = 64
    right_max_position_embeddings: int = 8
    conv_depthwise_kernel_size: int = 31
    layer_norm_eps: float = 1e-5


def teacher_config(cfg) -> W2vBertConfig:
    """The teacher of a codec ``Config``'s ``train`` section."""
    t = cfg.train
    return W2vBertConfig(num_hidden_layers=t.teacher_layers, num_attention_heads=t.teacher_heads,
                         intermediate_size=t.teacher_intermediate)


def _linear_init(n_out: int, n_in: int, bias: bool, generator) -> Weights:
    w = torch.randn((n_out, n_in), generator=generator) * 0.02
    return Weights(w, torch.zeros(n_out) if bias else None)


def _ln(n: int) -> Weights:
    return Weights(torch.ones(n), torch.zeros(n))


class _FFN(nn.Module):
    def __init__(self, h: int, inter: int, g):
        super().__init__()
        self.norm = _ln(h)
        self.inter = _linear_init(inter, h, True, g)
        self.out = _linear_init(h, inter, True, g)


class _Attention(nn.Module):
    def __init__(self, cfg: W2vBertConfig, g):
        super().__init__()
        h = cfg.hidden_size
        self.norm = _ln(h)
        self.q = _linear_init(h, h, True, g)
        self.k = _linear_init(h, h, True, g)
        self.v = _linear_init(h, h, True, g)
        self.out = _linear_init(h, h, True, g)
        n_dist = cfg.left_max_position_embeddings + cfg.right_max_position_embeddings + 1
        self.distance_embedding = nn.Parameter(
            torch.randn((n_dist, h // cfg.num_attention_heads), generator=g) * 0.02)


class _ConvModule(nn.Module):
    def __init__(self, cfg: W2vBertConfig, g):
        super().__init__()
        h = cfg.hidden_size
        self.norm = _ln(h)
        self.pw1 = _linear_init(2 * h, h, False, g)
        self.dw = Weights(torch.randn((h, 1, cfg.conv_depthwise_kernel_size), generator=g) * 0.02)
        self.dw_norm = _ln(h)
        self.pw2 = _linear_init(h, h, False, g)


class _Layer(nn.Module):
    def __init__(self, cfg: W2vBertConfig, g):
        super().__init__()
        h, inter = cfg.hidden_size, cfg.intermediate_size
        self.ffn1 = _FFN(h, inter, g)
        self.attn = _Attention(cfg, g)
        self.conv = _ConvModule(cfg, g)
        self.ffn2 = _FFN(h, inter, g)
        self.final_norm = _ln(h)


class W2vBert(nn.Module):
    """The teacher's parameters, named as in the JAX tree; ``cfg`` rides along."""

    def __init__(self, cfg: W2vBertConfig | None = None, *, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg = cfg or W2vBertConfig()
        self.feat_norm = _ln(cfg.feature_projection_input_dim)
        self.feat_proj = _linear_init(cfg.hidden_size, cfg.feature_projection_input_dim,
                                      True, generator)
        self.layers = nn.ModuleList(_Layer(cfg, generator) for _ in range(cfg.num_hidden_layers))


def init_w2v_bert(cfg: W2vBertConfig | None = None, *, generator: torch.Generator,
                  device="cuda") -> W2vBert:
    """A random teacher (weights N(0, 0.02²), zero biases, unit norms), drawn
    on the CPU from ``generator``, frozen (no gradients), in eval mode on
    ``device`` (raises without a card unless ``device="cpu"``). A real
    teacher comes from ``load_w2v_bert_teacher``."""
    from .codec import resolve_device

    device = resolve_device(device)
    return freeze(W2vBert(cfg, generator=generator).to(device))


def freeze(teacher: W2vBert) -> W2vBert:
    """``requires_grad=False`` on every parameter, eval mode; returns it."""
    teacher.requires_grad_(False)
    return teacher.eval()


def _layer_norm(x, p: Weights, eps: float):
    return F.layer_norm(x, (x.shape[-1],), p.w, p.b, eps=eps)


def _ffn(x, p: _FFN, eps: float):
    return linear(F.silu(linear(_layer_norm(x, p.norm, eps), p.inter)), p.out)


def _distance_index(T: int, left: int, right: int, device) -> torch.Tensor:
    pos = torch.arange(T, device=device)
    return (pos[None, :] - pos[:, None]).clamp(-left, right) + left  # (T, T)


def _attention(x, p: _Attention, cfg: W2vBertConfig, valid_frames=None):
    B, T, C = x.shape
    H = cfg.num_attention_heads
    D = C // H
    h = _layer_norm(x, p.norm, cfg.layer_norm_eps)
    q, k, v = (linear(h, lin).reshape(B, T, H, D) for lin in (p.q, p.k, p.v))
    # the relative-key bias, q · E[clamp(r - l)], already scaled by 1/√D
    qe = torch.einsum("bthd,nd->bhtn", q, p.distance_embedding.to(q.dtype))
    idx = _distance_index(T, cfg.left_max_position_embeddings,
                          cfg.right_max_position_embeddings, x.device)
    bias = torch.gather(qe, -1, idx.expand(B, H, T, T)) * D ** -0.5
    if valid_frames is not None:
        key_ok = torch.arange(T, device=x.device)[None, :] < valid_frames[:, None].to(x.device)
        bias = bias + masked_bias(key_ok[:, None, None, :], bias.dtype)
    out = attend(q, k, v, bias).reshape(B, T, C)
    return x + linear(out, p.out)


def _conv_module(x, p: _ConvModule, cfg: W2vBertConfig):
    """LayerNorm -> pw1 + GLU -> causal depthwise k31 -> LayerNorm -> swish -> pw2."""
    h = linear(_layer_norm(x, p.norm, cfg.layer_norm_eps), p.pw1)
    a, b = h.chunk(2, dim=-1)
    h = (a * torch.sigmoid(b)).transpose(1, 2)  # (B, C, T)
    k = cfg.conv_depthwise_kernel_size
    h = conv1d(F.pad(h, (k - 1, 0)), p.dw.w, groups=h.shape[1]).transpose(1, 2)
    h = F.silu(_layer_norm(h, p.dw_norm, cfg.layer_norm_eps))
    return x + linear(h, p.pw2)


def _encoder_layer(x, p: _Layer, cfg: W2vBertConfig, valid_frames=None):
    eps = cfg.layer_norm_eps
    x = 0.5 * _ffn(x, p.ffn1, eps) + x
    x = _attention(x, p.attn, cfg, valid_frames)
    x = _conv_module(x, p.conv, cfg)
    x = 0.5 * _ffn(x, p.ffn2, eps) + x
    return _layer_norm(x, p.final_norm, eps)


def w2v_bert_project(teacher: W2vBert, features):
    """(projected features, normalised features) of features (B, T, 160)."""
    norm = _layer_norm(features, teacher.feat_norm, teacher.cfg.layer_norm_eps)
    return linear(norm, teacher.feat_proj), norm


def w2v_bert_apply(teacher: W2vBert, features, *, output_layer: int | None = None,
                   valid_frames=None):
    """features (B, T, 160) stacked fbank -> the list of hidden states (HF
    indexing), or only hidden_states[output_layer] (0: the projected input,
    i: the output of layer i - 1), computing no layer past it.
    ``valid_frames``: (B,) real frames per row; the pad keys are masked."""
    cfg = teacher.cfg
    h, _ = w2v_bert_project(teacher, features)
    hiddens = [h]
    for layer in teacher.layers:
        if output_layer is not None and len(hiddens) > output_layer:
            break
        h = _encoder_layer(h, layer, cfg, valid_frames)
        hiddens.append(h)
    return hiddens if output_layer is None else hiddens[output_layer]


# ---------------------------------------------------------------------------
# HF snapshots
# ---------------------------------------------------------------------------

def convert_w2v_bert(sd: Mapping[str, Any], cfg: W2vBertConfig) -> dict[str, torch.Tensor]:
    """An HF ``Wav2Vec2BertModel`` state dict (tensors or numpy arrays) ->
    ``W2vBert``'s state dict (CPU tensors, copied)."""
    def t(k):
        v = sd[k]
        return (v.detach().to("cpu").clone() if torch.is_tensor(v)
                else torch.from_numpy(np.array(v, copy=True)))

    out: dict[str, torch.Tensor] = {}

    def lin(ours, theirs):
        out[f"{ours}.w"] = t(theirs + ".weight")
        if theirs + ".bias" in sd:
            out[f"{ours}.b"] = t(theirs + ".bias")

    def ln(ours, theirs):
        out[f"{ours}.w"], out[f"{ours}.b"] = t(theirs + ".weight"), t(theirs + ".bias")

    ln("feat_norm", "feature_projection.layer_norm")
    lin("feat_proj", "feature_projection.projection")
    for i in range(cfg.num_hidden_layers):
        pre, ours = f"encoder.layers.{i}", f"layers.{i}"
        for ffn in ("ffn1", "ffn2"):
            ln(f"{ours}.{ffn}.norm", f"{pre}.{ffn}_layer_norm")
            lin(f"{ours}.{ffn}.inter", f"{pre}.{ffn}.intermediate_dense")
            lin(f"{ours}.{ffn}.out", f"{pre}.{ffn}.output_dense")
        ln(f"{ours}.attn.norm", f"{pre}.self_attn_layer_norm")
        for name in ("q", "k", "v", "out"):
            lin(f"{ours}.attn.{name}", f"{pre}.self_attn.linear_{name}")
        out[f"{ours}.attn.distance_embedding"] = t(f"{pre}.self_attn.distance_embedding.weight")
        ln(f"{ours}.conv.norm", f"{pre}.conv_module.layer_norm")
        out[f"{ours}.conv.pw1.w"] = t(f"{pre}.conv_module.pointwise_conv1.weight")[:, :, 0]
        out[f"{ours}.conv.dw.w"] = t(f"{pre}.conv_module.depthwise_conv.weight")
        ln(f"{ours}.conv.dw_norm", f"{pre}.conv_module.depthwise_layer_norm")
        out[f"{ours}.conv.pw2.w"] = t(f"{pre}.conv_module.pointwise_conv2.weight")[:, :, 0]
        ln(f"{ours}.final_norm", f"{pre}.final_layer_norm")
    return out


def snapshot_config(model_path) -> W2vBertConfig:
    """The teacher's shape from an HF snapshot's ``config.json`` (the fields
    of ``W2vBertConfig`` it has), w2v-bert-2.0's without one."""
    path = Path(model_path) / "config.json"
    if not path.exists():
        return W2vBertConfig()
    hf = json.loads(path.read_text())
    return W2vBertConfig(**{f.name: hf[f.name] for f in fields(W2vBertConfig) if f.name in hf})


def load_w2v_bert_teacher(model_path, cfg: W2vBertConfig | None = None, *,
                          device="cuda") -> W2vBert:
    """The frozen teacher from a local HF snapshot directory: its
    ``model.safetensors`` (read with the ``safetensors`` package) or else
    its ``pytorch_model.bin`` (``torch.load(weights_only=True)``), of shape
    ``cfg`` (default: ``snapshot_config``), on ``device`` (raises without a
    card unless ``device="cpu"``). Nothing is downloaded."""
    from .codec import resolve_device

    device = resolve_device(device)
    cfg = cfg or snapshot_config(model_path)
    p = Path(model_path)
    st = p / "model.safetensors"
    if st.exists():
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise ImportError(f"reading {st} needs the safetensors package "
                              "(pip install safetensors)") from e
        sd = load_file(str(st))
    elif (p / "pytorch_model.bin").exists():
        sd = torch.load(p / "pytorch_model.bin", map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(f"no model.safetensors or pytorch_model.bin under {p}")
    teacher = W2vBert(cfg, generator=torch.Generator().manual_seed(0))  # overwritten below
    teacher.load_state_dict(convert_w2v_bert(sd, cfg))
    return freeze(teacher.to(device))


def build_teacher(cfg, *, path=None, init=None, device="cuda") -> W2vBert:
    """The frozen teacher of ``cfg.train``'s shape on ``device``: from the
    local snapshot ``path``, or random from seed 0 with ``init == "random"``;
    SystemExit otherwise (the train and eval CLIs' ``--w2v_bert_path`` /
    ``--w2v_bert_init``)."""
    tc = teacher_config(cfg)
    if path:
        return load_w2v_bert_teacher(path, tc, device=device)
    if init == "random":
        print("[teacher] using a RANDOM-INIT w2v-bert teacher (smoke mode); "
              "pass --w2v_bert_path for real distillation")
        return init_w2v_bert(tc, generator=torch.Generator().manual_seed(0), device=device)
    raise SystemExit(
        "cfg.train.use_semantic needs teacher features: pass --semantic_dir "
        "(precomputed targets), --w2v_bert_path (local HF snapshot), or "
        "--w2v_bert_init random (smoke test)")
