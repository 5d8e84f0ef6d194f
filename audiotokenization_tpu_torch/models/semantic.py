"""The semantic-distillation branch (counterpart of
``audiotokenization_tpu/models/semantic.py``).

With ``train.use_semantic`` the frozen w2v-bert teacher's hidden layer
``train.teacher_layer`` (16) is regressed from the quantized latents:

  teacher = w2v_bert(feats).hidden_states[16].T             (B, 1024, Tf)
  sem = SemanticEncoder(teacher)                            (B, 1024, Tf)
  vq_in = fc_prior(concat(sem, latents) or latents)
  zq, codes, vq_loss = quantizer(vq_in)
  sem_recon = SemanticDecoder(fc_post_s(zq))
  semantic_recon_loss = mse(sem_recon, teacher)              (x5 in the gen loss)
  wav = decoder(fc_post_a(zq))

The teacher's output arrives either precomputed (``semantic_target``
(B, 1024, Tf), ``cli/precompute_semantic.py``) or from the teacher run on
the batch's ``feats`` (B, Tf', 160) (``teacher_target``). The teacher is a
separate module (``models/w2v_bert.py``), never a part of the codec's
state: it takes no gradient and no optimizer step, as in the JAX step,
where it rides outside ``gen_params``.

``Semantic``'s keys are the JAX tree's (``semantic.fc_prior.w``,
``semantic.encoder.initial.w``, ...). Its convolutions and linears are
stock PyTorch ops (cuBLAS, cuDNN), as XLA runs them in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import Weights, conv1d, init_conv1d, init_linear, linear
from .bigcodec import edge_mask
from .w2v_bert import w2v_bert_apply

TEACHER_DIM = 1024


def _conv_k3(in_ch: int, out_ch: int, *, bias: bool, generator) -> Weights:
    p = init_conv1d(in_ch, out_ch, 3, generator=generator)
    return p if bias else Weights(p.w.data)


class SemanticBottleneck(nn.Module):
    """SemanticEncoder / SemanticDecoder: k3 conv -> [ReLU, conv, ReLU, conv]
    residual -> k3 conv, 1024 channels throughout (``initial`` and ``final``
    without bias)."""

    def __init__(self, *, generator: torch.Generator, dim: int = TEACHER_DIM):
        super().__init__()
        self.initial = _conv_k3(dim, dim, bias=False, generator=generator)
        self.res1 = _conv_k3(dim, dim, bias=True, generator=generator)
        self.res2 = _conv_k3(dim, dim, bias=True, generator=generator)
        self.final = _conv_k3(dim, dim, bias=False, generator=generator)


class Semantic(nn.Module):
    """``fc_prior`` (latents [+ 1024] -> the decoder's width), ``fc_post_a``
    and ``fc_post_s`` (to 1024), the bottlenecks ``encoder`` and ``decoder``."""

    def __init__(self, cfg, *, generator: torch.Generator):
        super().__init__()
        e, d = cfg.model.codec_encoder, cfg.model.codec_decoder
        prior_in = TEACHER_DIM + e.out_channels if cfg.train.concat_semantic else e.out_channels
        self.fc_prior = init_linear(prior_in, d.in_channels, generator=generator)
        self.fc_post_a = init_linear(d.in_channels, d.in_channels, generator=generator)
        self.fc_post_s = init_linear(d.in_channels, TEACHER_DIM, generator=generator)
        self.encoder = SemanticBottleneck(generator=generator)
        self.decoder = SemanticBottleneck(generator=generator)


def _conv(p: Weights, x, keep=None):
    """A 'same' conv; ``keep`` (B,) frames: each sample's positions past it
    zeroed after the conv, as its own file's zero padding would leave them."""
    w = p.w
    y = conv1d(x, w, p._parameters.get("b"), padding=(w.shape[-1] - 1) // 2)
    return y if keep is None else edge_mask(y, keep)


def semantic_bottleneck(p: SemanticBottleneck, x, frames=None):
    """x (B, C, T) -> (B, C, T). ``frames`` (B,): a ragged batch's frame
    counts, each sample's tail zeroed after every conv
    (``utils/ragged.py``'s masked form)."""
    h = _conv(p.initial, x, frames)
    r = _conv(p.res1, F.relu(h), frames)
    r = _conv(p.res2, F.relu(r), frames)
    return _conv(p.final, r + h, frames)


def channels_linear(x, p):
    """A linear layer over the channels of x (B, C, T)."""
    return linear(x.transpose(1, 2), p).transpose(1, 2)


def align_frames(target, frames: int):
    """The teacher's (B, 1024, T') zero-padded or trimmed to ``frames``
    (the encoder's strided convs round some lengths up)."""
    if target.shape[-1] < frames:
        target = F.pad(target, (0, frames - target.shape[-1]))
    return target[..., :frames]


def teacher_target(teacher, feats, frames: int, layer: int, *, valid_frames=None):
    """The teacher's hidden layer ``layer`` of feats (B, T', 160) (or the
    reference collate's (B, 1, T', 160)) as (B, 1024, frames), detached.
    ``valid_frames`` (B,): each row's feature frames; the pad keys are masked
    (at least one key a row) and the output is zero past them."""
    if feats.ndim == 4:
        feats = feats[:, 0]
    keys = None if valid_frames is None else valid_frames.clamp(min=1)
    hidden = w2v_bert_apply(teacher, feats, output_layer=layer, valid_frames=keys).transpose(1, 2)
    if valid_frames is not None:
        pad = torch.arange(hidden.shape[-1], device=hidden.device) >= valid_frames[:, None]
        hidden = hidden.masked_fill(pad[:, None, :], 0.0)
    return align_frames(hidden, frames).detach()


def semantic_vq_in(sem: Semantic, cfg, latents, semantic_target=None, *, frames=None):
    """The quantizer's input: fc_prior(latents), or with ``concat_semantic``
    fc_prior(concat(SemanticEncoder(teacher), latents)), the teacher
    ``semantic_target`` (B, 1024, T') aligned to the latents' frames.
    ``frames``: a ragged batch's frame counts (the teacher zeroed past each
    and the bottleneck masked)."""
    if cfg.train.concat_semantic:
        if semantic_target is None:
            raise ValueError(
                "concat_semantic checkpoints quantize concat(semantic, latents); pass "
                "semantic_target (B, 1024, Tf), e.g. precomputed w2v-bert layer-16 "
                "features (cli/precompute_semantic.py)")
        t = align_frames(semantic_target, latents.shape[-1]).detach().to(latents.dtype)
        if frames is not None:
            t = edge_mask(t, frames)
        latents = torch.cat([semantic_bottleneck(sem.encoder, t, frames), latents], dim=1)
    return channels_linear(latents, sem.fc_prior)


def semantic_recon_loss(sem: Semantic, zq, target):
    """mean((SemanticDecoder(fc_post_s(zq)) - target)²), fp32."""
    recon = semantic_bottleneck(sem.decoder, channels_linear(zq, sem.fc_post_s))
    return torch.mean(torch.square((recon - target.to(recon.dtype)).float()))
