"""wav2vec 2.0 / HuBERT / UniSpeech-SAT, the other SSL upstreams of the
speaker-verification suite (counterpart of ``audiotokenization_tpu/models/
wav2vec2.py``). The three share one encoder, which is WavLM's
(``models/wavlm.py``) without the gated relative position bias: plain
softmax attention, post-LN ('group', base) or stable pre-LN ('layer',
large), and one state-dict layout (transformers' ``modeling_wav2vec2.py``,
``modeling_hubert.py``, ``modeling_unispeech_sat.py``).

``load_ssl_upstream(sd, family)`` is the one entry point for all four
families: it infers the config from the weights' shapes
(``infer_config_from_sd``), converts the state dict and returns
``(ssl_fn, cfg)`` with the model on the card (or ``device="cpu"``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Tuple

import torch

from .wavlm import (SslEncoder, WavLMConfig, convert_wavlm, encoder_apply, load_ssl_model,
                    make_ssl_fn)


@dataclasses.dataclass
class Wav2Vec2Config:
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
    do_stable_layer_norm: bool = False  # True for the -large checkpoints
    layer_norm_eps: float = 1e-5


def wav2vec2_apply(model: SslEncoder, wav, *, output_layer: int | None = None):
    """The hidden states of wav (B, T) (``models/wavlm.py::encoder_apply``)."""
    if model.gated:
        raise ValueError("wav2vec2_apply needs a model without the gated position bias")
    return encoder_apply(model, wav, output_layer=output_layer)


def convert_wav2vec2(sd: Mapping[str, Any], cfg: Wav2Vec2Config) -> dict[str, torch.Tensor]:
    """A transformers {Wav2Vec2,Hubert,UniSpeechSat}Model state dict ->
    ``SslEncoder``'s state dict. Pretraining-only keys (masked_spec_embed,
    quantizer and projection heads) are ignored."""
    return convert_wavlm(sd, cfg, _family="wav2vec2")


_CANONICAL_STRIDE = {7: (5, 2, 2, 2, 2, 2, 2)}
FAMILIES = ("wavlm", "wav2vec2", "hubert", "unispeech_sat")


def infer_config_from_sd(sd: Mapping[str, Any], family: str, *, num_attention_heads=None,
                         conv_stride=None):
    """The config of a transformers state dict, so that any published
    checkpoint of the family loads without a config file. Read from the
    weights: conv dims and kernels, hidden and intermediate sizes, layer
    count, norm layout, conv bias, pos-conv kernel and groups, WavLM's
    bucket count and heads (``rel_attn_embed`` is (buckets, heads)). By
    the published checkpoints' conventions: head dim 64 for the others, the
    canonical 7-stage stride (5, 2, 2, 2, 2, 2, 2), max bucket distance 800,
    stable pre-LN iff the extractor is 'layer'. ``num_attention_heads`` /
    ``conv_stride`` override."""
    def shape(k):
        return tuple(sd[k].shape)

    n_conv = 1 + max(int(k.split(".")[2]) for k in sd
                     if k.startswith("feature_extractor.conv_layers."))
    conv = [shape(f"feature_extractor.conv_layers.{i}.conv.weight") for i in range(n_conv)]
    if conv_stride is None:
        if n_conv not in _CANONICAL_STRIDE:
            raise ValueError(f"cannot infer conv_stride for a {n_conv}-stage feature "
                             "extractor; pass conv_stride explicitly")
        conv_stride = _CANONICAL_STRIDE[n_conv]
    hidden = shape("feature_projection.projection.weight")[0]
    n_layers = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("encoder.layers."))
    inter = shape("encoder.layers.0.feed_forward.intermediate_dense.weight")[0]
    norm = "layer" if "feature_extractor.conv_layers.1.layer_norm.weight" in sd else "group"
    pc = "encoder.pos_conv_embed.conv"
    for key in (f"{pc}.parametrizations.weight.original1", f"{pc}.weight_v", f"{pc}.weight"):
        if key in sd:
            pos_shape = shape(key)
            break
    else:
        raise ValueError(
            "cannot locate the pos_conv weight in the state dict (looked "
            f"for {pc}.{{parametrizations.weight.original1,weight_v,weight}})"
            " — is this a transformers-layout checkpoint?")
    rel = "encoder.layers.0.attention.rel_attn_embed.weight"
    if num_attention_heads is None and family == "wavlm":
        num_attention_heads = shape(rel)[1]
    kw = dict(
        num_conv_pos_embeddings=pos_shape[2],
        num_conv_pos_embedding_groups=hidden // pos_shape[1],
        hidden_size=hidden, num_hidden_layers=n_layers,
        num_attention_heads=num_attention_heads or max(1, hidden // 64),
        intermediate_size=inter, conv_dim=tuple(s[0] for s in conv),
        conv_kernel=tuple(s[2] for s in conv), conv_stride=tuple(conv_stride),
        feat_extract_norm=norm,
        conv_bias="feature_extractor.conv_layers.0.conv.bias" in sd,
        do_stable_layer_norm=(norm == "layer"))
    if family == "wavlm":
        return WavLMConfig(**kw, num_buckets=shape(rel)[0])
    return Wav2Vec2Config(**kw)


def load_ssl_upstream(sd: Mapping[str, Any], family: str, *, device="cuda", **infer_kw):
    """(transformers state dict, family) -> (ssl_fn, cfg), the model frozen
    on ``device`` (raises without a card unless ``device="cpu"``) as
    ``ssl_fn.model``. ``infer_kw``: ``infer_config_from_sd``'s overrides."""
    if family not in FAMILIES:
        raise ValueError(f"unknown SSL family {family!r}")
    cfg = infer_config_from_sd(sd, family, **infer_kw)
    gated = family == "wavlm"
    tensors = convert_wavlm(sd, cfg, _family="wavlm" if gated else "wav2vec2")
    return make_ssl_fn(load_ssl_model(tensors, cfg, gated=gated, device=device)), cfg
