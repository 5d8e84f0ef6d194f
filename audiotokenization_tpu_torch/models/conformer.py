"""Conformer STFT encoder and ISTFT decoder (counterpart of
``audiotokenization_tpu/models/conformer.py``; ``configs/conformer.yaml``
is the reference's config1: hop 200, n_fft = win 800, dim 256, 6 layers of
8 heads, RoPE θ 500).

Encoder: STFT (center=False after (win - hop) / 2 zeros on both sides) ->
cat(real, imag) -> 1x1 ``input_proj`` -> RMS norm -> backbone
(``conv_first``) -> RMS norm -> weight-normed 1x1 ``output_proj`` when
``out_channels != dim``.

Decoder: weight-normed 1x1 ``input_proj`` when ``in_channels != dim`` ->
backbone (attention first) -> RMS norm -> ISTFT head (Linear dim -> n_fft
+ 2, magnitude min(exp(·), 1e2), phase by cos/sin, ``istft_same``).

Parameter names are the JAX tree's paths (``backbone.layers.0.attn.qkv.w``,
...), so ``convert.params_from_jax`` maps a JAX tree key for key. Both take
``valid`` (B,) frame counts for ragged batches: the STFT front needs no
mask (its zero padding is the batch's zero tail), the backbone masks, the
ISTFT takes each sample's own envelope. The FFTs run in fp32 whatever the
parameters' dtype; the backbone runs in the parameters' dtype.

Both take ``backbone_fn``, a replacement for the sequential backbone: the
hook ``parallel/pp.py`` runs the layers through as a GPipe pipeline; inside
its ``pp_train_context`` (pipeline-parallel training) the hook is taken
from there when none is given and the batch is not ragged.

Training under ``train.remat`` recomputes each backbone layer in the
backward (``remat``, as the JAX package's ``jax.checkpoint`` per layer);
the pipeline recomputes per layer under its own flag
(``parallel/pp.py``), and a layer is never wrapped twice.

``ffn_type: moe`` (configs/conformer_moe.yaml) makes the encoder's FFNs
MoE layers (``ops/moe.py``); the encoder's ``forward`` then appends their
aux losses to its ``aux`` list. The decoder's FFNs are dense whatever its
``ffn_type`` says: the JAX package's ``init_codec`` passes ``ffn_type`` to
the encoder only, so its MoE run dirs hold a dense decoder, and the port
builds the same tree.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.conv import (WeightNormed, get_weight, init_conv1d, init_linear,
                        kaiming_uniform_fan_in, linear, pointwise, uniform_fan_in_bias)
from ..ops.stft import istft_same, stft_same_constant_pad
from ..ops.transformer import ConformerBackbone, conformer_backbone, rms_norm


def _wn_pointwise(in_ch: int, out_ch: int, *, generator: torch.Generator) -> WeightNormed:
    """A weight-normed 1x1 conv at torch's defaults (kaiming-uniform v, g =
    ‖v‖, bias fan-in in_ch)."""
    w = kaiming_uniform_fan_in((out_ch, in_ch, 1), generator=generator)
    return WeightNormed(w, uniform_fan_in_bias((out_ch,), in_ch, generator=generator))


def _backbone(c, *, conv_first: bool, ffn_type: str, generator):
    return ConformerBackbone(c.dim, c.n_layers, n_head=c.n_head, ffn_mult=c.ffn_mult,
                             conv_kernel_size=c.conv_kernel_size, rope_theta=c.rope_theta,
                             max_seq_len=c.max_seq_len, conv_first=conv_first, causal=c.causal,
                             ffn_type=ffn_type, moe_experts=c.moe_experts,
                             moe_top_k=c.moe_top_k, moe_capacity_factor=c.moe_capacity_factor,
                             generator=generator)


class ConformerEncoder(nn.Module):
    """wav (B, 1, T) -> latents (B, out_channels, T / hop), from the
    ``codec_encoder`` group ``e`` of a config. No ``balanced`` mode: it has
    no conv front to split from a tail (as in the JAX package)."""

    modes = ("conformant", "high", "fast")

    @classmethod
    def from_config(cls, e, *, generator: torch.Generator):
        return cls(e, generator=generator)

    def __init__(self, e, *, generator: torch.Generator):
        super().__init__()
        self.hop_length, self.n_fft, self.window_size = e.hop_length, e.n_fft, e.window_size
        self.causal = e.causal
        self.input_proj = init_conv1d(2 * (e.n_fft // 2 + 1), e.dim, 1, generator=generator)
        self.input_norm = nn.Parameter(torch.ones(e.dim))
        self.backbone = _backbone(e, conv_first=True, ffn_type=e.ffn_type, generator=generator)
        self.norm = nn.Parameter(torch.ones(e.dim))
        if e.out_channels != e.dim:
            self.output_proj = _wn_pointwise(e.dim, e.out_channels, generator=generator)

    def stages(self, lengths=None, *, remat: bool = False, aux=None):
        """(front, tail) of ``forward``: the whole encoder and the identity.
        ``lengths``: (B,) samples of a zero-padded ragged batch. ``remat``:
        each backbone layer recomputed in the backward. ``aux``: the list
        the MoE layers append their aux losses to."""
        valid = None if lengths is None else lengths // self.hop_length
        return ((lambda x: conformer_encode(self, x, valid=valid, aux=aux, remat=remat)),
                (lambda y: y))

    def forward(self, x, *, lengths=None, remat: bool = False, aux=None):
        """``lengths``: (B,) samples of a ragged batch (latents past
        lengths // hop are meaningless); ``remat`` and ``aux`` as in
        ``stages``."""
        return self.stages(lengths, remat=remat, aux=aux)[0](x)


def encode_features(p: ConformerEncoder, spec):
    """complex STFT (B, F, T) -> the backbone's input (B, T, dim):
    cat(real, imag), cast to the parameters' dtype, input_proj, RMS norm."""
    feats = torch.cat([spec.real, spec.imag], dim=1).transpose(1, 2)
    feats = feats.to(get_weight(p.input_proj).dtype)
    return rms_norm(pointwise(feats, p.input_proj), p.input_norm)


def encode_output(p: ConformerEncoder, h):
    """The backbone's output (B, T, dim) -> latents (B, out_channels, T)."""
    h = rms_norm(h, p.norm)
    if hasattr(p, "output_proj"):
        h = pointwise(h, p.output_proj)
    return h.transpose(1, 2)


def _run_backbone(h, backbone, *, valid, aux, backbone_fn, remat):
    """The sequential backbone (``remat``: per layer), or ``backbone_fn``
    (the pipeline, which recomputes per layer under its own flag)."""
    if backbone_fn is None and valid is None:
        from ..parallel.pp import maybe_pp_backbone

        backbone_fn = maybe_pp_backbone(backbone)  # pipeline-parallel training
    if backbone_fn is None:
        return conformer_backbone(h, backbone, valid=valid, aux=aux, remat=remat)
    if valid is not None:
        raise ValueError("a backbone_fn takes no ragged valid frame counts")
    return backbone_fn(h, backbone)


def conformer_encode(p: ConformerEncoder, x, *, valid=None, aux=None, backbone_fn=None,
                     remat: bool = False):
    """x (B, 1, T) -> latents (B, out_channels, T / hop); ``valid``: (B,)
    frame counts of a ragged batch (latents past them are meaningless);
    ``aux``: the list the MoE layers append their aux losses to.
    ``backbone_fn``: a (h (B, T, dim), backbone) -> h replacement for the
    sequential backbone, the hook ``parallel/pp.py`` pipelines it through.
    ``remat``: the sequential backbone's layers recomputed in the backward."""
    spec = stft_same_constant_pad(x[:, 0], n_fft=p.n_fft, hop_length=p.hop_length,
                                  win_length=p.window_size)
    h = _run_backbone(encode_features(p, spec), p.backbone, valid=valid, aux=aux,
                      backbone_fn=backbone_fn, remat=remat)
    return encode_output(p, h)


class ConformerDecoder(nn.Module):
    """quantized latents (B, in_channels, Tf) -> waveform (B, 1, Tf · hop),
    from the ``codec_decoder`` group ``d`` of a config."""

    @classmethod
    def from_config(cls, d, *, generator: torch.Generator):
        return cls(d, generator=generator)

    def __init__(self, d, *, generator: torch.Generator):
        super().__init__()
        self.hop_length, self.n_fft = d.hop_length, d.n_fft
        self.causal = d.causal
        self.backbone = _backbone(d, conv_first=False, ffn_type="dense",  # module docstring
                                  generator=generator)
        self.norm = nn.Parameter(torch.ones(d.dim))
        self.head_out = init_linear(d.dim, d.n_fft + 2, generator=generator)
        if d.in_channels != d.dim:
            self.input_proj = _wn_pointwise(d.in_channels, d.dim, generator=generator)

    def forward(self, x, *, frames=None, remat: bool = False):
        """``frames``: (B,) frame counts of a ragged batch; ``remat``: each
        backbone layer recomputed in the backward."""
        return conformer_decode(self, x, valid=frames, remat=remat)


def head_spectrum(p: ConformerDecoder, h):
    """The ISTFT head's spectrum of the backbone's normed output h (B, T,
    dim): complex64 (B, T, n_fft // 2 + 1), magnitude min(exp(·), 1e2)."""
    mag, phase = linear(h, p.head_out).chunk(2, dim=-1)
    mag = torch.clamp(torch.exp(mag), max=1e2).float()
    return torch.complex(mag * torch.cos(phase).float(), mag * torch.sin(phase).float())


def conformer_decode(p: ConformerDecoder, x, *, valid=None, backbone_fn=None,
                     remat: bool = False):
    """x (B, in_channels, Tf) -> (B, 1, Tf · hop); ``valid``: (B,) frame
    counts of a ragged batch (pad frames add nothing to the overlap-add,
    each sample's envelope is its own); ``backbone_fn`` and ``remat`` as in
    ``conformer_encode``."""
    h = x.transpose(1, 2)
    if hasattr(p, "input_proj"):
        h = pointwise(h, p.input_proj)
    h = rms_norm(_run_backbone(h, p.backbone, valid=valid, aux=None, backbone_fn=backbone_fn,
                               remat=remat), p.norm)
    spec = head_spectrum(p, h).transpose(1, 2)
    return istft_same(spec, n_fft=p.n_fft, hop_length=p.hop_length, win_length=p.n_fft,
                      valid=valid)[:, None, :]
