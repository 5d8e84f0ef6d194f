"""Codec facade: encoder + quantizer + decoder.

Counterpart of ``audiotokenization_tpu/models/codec.py`` for the two codec
families, BigCodec (``models/bigcodec.py``) and the Conformer STFT/ISTFT
codec (``models/conformer.py``), each side built from its ``type``, with
the factorized VQ (``quantizers/factorized_vq.py``) or FSQ
(``quantizers/fsq.py``; ``fsq: true``) as its quantizer. The serving path is
``tokenize`` (wav -> codes (Nq, B, Tf)) and ``codes_to_emb`` ->
``apply_fc_post_a`` -> ``decode`` (codes -> wav); training runs
``forward`` (wav -> regenerated wav, commitment losses and codes).

Precision: cuDNN runs fp32 convolutions in TF32 unless told not to, which
flips tokens as the TPU's bf16 default did. ``full_fp32()`` turns TF32 off
for matmuls and cuDNN and restores the flags after; conformant ``tokenize``
runs inside it (the other modes: ``encode_in_mode``), and so should
``decode`` wherever waveforms are held to the conformance tolerances.
``forward`` follows ``train.precision``: ``fp32_strict`` inside
``full_fp32()``, ``fp32`` with TF32 allowed (``allow_tf32()``), ``bf16``
(training) on bf16 copies of every generator parameter but the
quantizer's. The quantizer is always fp32.

A Conformer encoder with ``ffn_type: moe`` adds the router's aux losses to
``forward``'s output (``moe_aux_loss``: [load balance, router z, dropped
share], means over the MoE layers); tokenize and decode discard them.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, NamedTuple

import torch
from torch import nn

from ..config import Config, quantizer_kind, resolve_remat
from ..ops.moe import MoEFeedForward
from ..ops.params import cast_parameters, parameters_as
from . import bigcodec, conformer
from .quantizers import factorized_vq as fvq
from .quantizers import fsq


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. CUDA without a card raises: the
    port never drops to the CPU on its own; pass ``device="cpu"`` for the
    plain PyTorch versions."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to "
                           "run the plain PyTorch versions of the kernels")
    return device


@contextlib.contextmanager
def _tf32(allow: bool):
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def full_fp32():
    """fp32 matmuls and cuDNN convolutions/RNNs without TF32, for the body."""
    return _tf32(False)


def allow_tf32():
    """fp32 matmuls and cuDNN convolutions/RNNs in TF32, for the body: the
    card's counterpart of the JAX package's "fp32 tensors with fast matmuls"."""
    return _tf32(True)


def precision_scope(cfg: Config):
    """The matmul precision of ``train.precision`` (fp32_strict: no TF32)."""
    p = cfg.train.precision
    if p not in ("bf16", "fp32", "fp32_strict"):
        raise ValueError(f"unknown train.precision {p!r}")
    return full_fp32() if p == "fp32_strict" else allow_tf32()


# each side's families by config ``type``: ``from_config`` builds one; its
# ``forward`` takes ragged ``lengths`` (encoder) or ``frames`` (decoder) and
# ``remat``; an encoder's ``stages`` is its (front, tail) split and ``modes``
# its tokenize modes
ENCODERS = {"bigcodec": bigcodec.BigCodecEncoder, "conformer_stft": conformer.ConformerEncoder}
DECODERS = {"bigcodec": bigcodec.BigCodecDecoder, "conformer_istft": conformer.ConformerDecoder}


def check_config(cfg: Config):
    """Raise for what the port does not build: an unknown family
    (``ValueError``), a quantizer other than the factorized VQ and FSQ, the
    semantic branch (``NotImplementedError`` citing the ROADMAP item)."""
    e, d = cfg.model.codec_encoder, cfg.model.codec_decoder
    for part, name, family in ((e, "encoder", ENCODERS), (d, "decoder", DECODERS)):
        if part.type not in family:
            raise ValueError(f"unknown {name} type {part.type!r}")
    quantizer = quantizer_kind(cfg)
    if quantizer not in ("fvq", "fsq"):
        raise NotImplementedError(f"the {quantizer!r} quantizer is not ported yet "
                                  "(ROADMAP Queue 1 item 14)")
    if cfg.train.use_semantic:
        raise NotImplementedError("the semantic branch is not ported yet "
                                  "(ROADMAP Queue 1 item 15)")


def uses_moe(cfg: Config) -> bool:
    """Whether a side's config asks for the MoE feed-forward (as the JAX
    package's ``uses_moe``; only the Conformer encoder builds one,
    ``models/conformer.py``)."""
    return "moe" in (cfg.model.codec_encoder.ffn_type, cfg.model.codec_decoder.ffn_type)


class Codec(nn.Module):
    """Encoder (BigCodec or Conformer), quantizer (factorized residual VQ or
    FSQ) and decoder (BigCodec or Conformer), with parameter names as in
    the JAX tree (``encoder``, ``quantizer``, ``decoder``)."""

    def __init__(self, cfg: Config, *, generator: torch.Generator):
        super().__init__()
        check_config(cfg)
        e, d = cfg.model.codec_encoder, cfg.model.codec_decoder
        self.cfg = cfg
        self.encoder = ENCODERS[e.type].from_config(e, generator=generator)
        self.decoder = DECODERS[d.type].from_config(d, generator=generator)
        if quantizer_kind(cfg) == "fsq":
            self.quantizer = fsq.FSQ(dim=d.in_channels, levels=d.fsq_levels, generator=generator)
        else:
            self.quantizer = fvq.ResidualVQ(
                num_quantizers=d.vq_num_quantizers, dim=d.in_channels,
                codebook_size=d.codebook_size, codebook_dim=d.codebook_dim,
                generator=generator)
        # whether encode() collects MoE aux losses (an MoE layer in the encoder)
        self.encoder_moe = any(isinstance(m, MoEFeedForward) for m in self.encoder.modules())


class CodecOutput(NamedTuple):
    gt_wav: torch.Tensor    # (B, 1, T)
    gen_wav: torch.Tensor   # (B, 1, T)
    vq_loss: torch.Tensor   # (Nq,) fp32
    vq_code: torch.Tensor   # (Nq, B, Tf) int32
    # (3,) fp32 [load balance, router z, dropped share (no gradient)], means
    # over the MoE layers; None without one
    moe_aux_loss: torch.Tensor | None = None


def init_codec(cfg: Config, *, generator: torch.Generator, device="cuda") -> Codec:
    """A randomly initialised codec (weights drawn on the CPU from
    ``generator``), moved to ``device`` in eval mode (a trainer calls
    ``.train()``: cuDNN's LSTM has no backward in eval mode)."""
    device = resolve_device(device)
    return Codec(cfg, generator=generator).to(device).eval()


def encode(codec: Codec, wav, *, remat: bool = False, aux=None):
    """wav (B, T) -> latents (B, C, Tf). ``remat`` recomputes BigCodec's
    blocks in the backward; the Conformer keeps its activations. ``aux``: a
    list the encoder's MoE layers append their aux losses to (an encoder
    without one takes none)."""
    if aux is None or not codec.encoder_moe:
        return codec.encoder(wav[:, None, :], remat=remat)
    return codec.encoder(wav[:, None, :], remat=remat, aux=aux)


def quantize(codec: Codec, latents, *, training: bool = False):
    """latents (B, C, Tf) -> (quantized (B, C, Tf), codes (Nq, B, Tf), loss (Nq,)).
    An fp32 island: bf16 latents go up to fp32, and the quantized latents
    come back in the latents' dtype; the VQ's loss stays fp32, FSQ's is a
    zero of the latents' dtype (it has no commitment loss)."""
    d = codec.cfg.model.codec_decoder
    if quantizer_kind(codec.cfg) == "fsq":
        zq, codes = fsq.fsq_apply(codec.quantizer, latents)
        codes = codes[None]
        loss = torch.zeros((1,), dtype=latents.dtype, device=latents.device)
    else:
        zq, codes, loss = fvq.residual_vq_apply(codec.quantizer, latents.float(),
                                                num_quantizers=d.vq_num_quantizers,
                                                commitment=d.vq_commit_weight, training=training)
    return zq.to(latents.dtype), codes, loss


def decode(codec: Codec, quantized, *, remat: bool = False):
    """quantized latents (B, C, Tf) -> waveform (B, 1, Tf · hop); ``remat``
    as in ``encode``."""
    return codec.decoder(quantized, remat=remat)


def forward(codec: Codec, batch: Dict[str, Any], *, training: bool = False,
            step=None) -> CodecOutput:
    """batch {"wav": (B, T)} -> CodecOutput: encode -> quantize -> decode,
    under ``train.precision`` (module docstring). In bf16 training the wav
    and every parameter but the quantizer's run as bf16 copies, and
    gradients reach the fp32 masters through the casts. ``training`` also
    turns on the commitment losses and, per ``resolve_remat``, per-block
    recomputation. ``step`` salts the EMA quantizers in the JAX package; the
    factorized VQ and FSQ draw nothing and ignore it. The encoder's MoE
    layers' aux losses are averaged into ``moe_aux_loss`` (JAX
    ``codec.py:221-229``)."""
    cfg = codec.cfg
    wav = batch["wav"]
    remat = training and resolve_remat(cfg)
    cast = {}
    if training and cfg.train.precision == "bf16":
        cast = cast_parameters(codec, torch.bfloat16, skip="quantizer")
        wav = wav.to(torch.bfloat16)
    aux = []
    with precision_scope(cfg), parameters_as(codec, cast):
        zq, codes, vq_loss = quantize(codec, encode(codec, wav, remat=remat, aux=aux),
                                      training=training)
        gen = decode(codec, zq, remat=remat)
    moe = None
    if aux:
        moe = torch.stack([sum(a[k] for a in aux) / len(aux)
                           for k in ("load_balance_loss", "router_z_loss", "dropped_frac")])
    return CodecOutput(gt_wav=wav[:, None, :], gen_wav=gen, vq_loss=vq_loss, vq_code=codes,
                       moe_aux_loss=moe)


def codes_to_emb(codec: Codec, codes, *, proj: bool = True):
    """codes (B, Tf, Nq) -> decoder-input embeddings (B, C, Tf); FSQ reads
    the one codebook's codes[..., 0] (``proj`` is the VQ's)."""
    if quantizer_kind(codec.cfg) == "fsq":
        return fsq.fsq_codes_to_emb(codec.quantizer, codes[..., 0]).transpose(1, 2)
    return fvq.residual_vq_codes_to_emb(codec.quantizer, codes, proj=proj).transpose(1, 2)


def apply_fc_post_a(codec: Codec, emb):
    """Semantic checkpoints decode fc_post_a(z_q); the port builds no semantic
    branch yet (``Codec`` refuses ``use_semantic``), so embeddings pass
    through unchanged, as they do for non-semantic trees in JAX."""
    return emb


MODES = ("conformant", "high", "balanced", "fast")


def check_mode(encoder_cls, mode: str):
    """``ValueError`` unless ``mode`` is a tokenize mode of ``encoder_cls``
    (``balanced`` splits BigCodec's conv front from its tail; the Conformer
    has no such split and no such mode, as in the JAX package)."""
    if mode not in MODES:
        raise ValueError(f"unknown tokenize mode {mode!r}")
    if mode not in encoder_cls.modes:
        raise ValueError(f"the {encoder_cls.__name__} has no {mode!r} tokenize mode "
                         f"(it has {', '.join(encoder_cls.modes)})")


def bf16_copies(module: nn.Module, prefixes=None) -> dict:
    """bf16 copies of ``module``'s parameters (those whose names start with
    one of ``prefixes``; all with None), made once and kept on the module
    until a parameter changes (its version counter or storage; a write
    through ``.data`` bumps neither), so that serving does not recast the
    encoder every call."""
    named = [(n, p) for n, p in module.named_parameters()
             if prefixes is None or n.startswith(prefixes)]
    stamp = tuple((p.data_ptr(), p._version) for _, p in named)
    cache = module.__dict__.setdefault("_bf16_copies", {})
    if prefixes not in cache or cache[prefixes][0] != stamp:
        cache[prefixes] = (stamp, {n: p.detach().to(torch.bfloat16) for n, p in named})
    return cache[prefixes][1]


def encode_in_mode(encoder: nn.Module, x, mode: str, *, lengths=None):
    """The encoder's latents of x (B, 1, T) at the precision of a tokenize
    ``mode``, without gradients; ``lengths``: (B,) samples of a ragged
    batch. Returns fp32 latents. The encoder's ``stages`` split it into a
    front and a tail (BigCodec: the conv stack, then the ResLSTM,
    snake_out and conv_out; the Conformer: all of it, then nothing).

    - ``conformant``: fp32, TF32 off for cuDNN and cuBLAS;
    - ``high``: fp32 tensors, cuDNN convs and LSTM and cuBLAS in TF32;
    - ``balanced`` (BigCodec only, ``check_mode``): the front on bf16
      copies of its parameters, the tail in fp32 with TF32 off;
    - ``fast``: the whole encoder on bf16 copies, from the input rounded
      to bf16 (the Conformer's STFT then runs in fp32 on it).

    The bf16 copies are made once per encoder (``bf16_copies``). K2 has no
    TF32 or bf16 form (the JAX package's Pallas K2 takes fp32 only): in
    every mode each fused unit is the fp32-grade kernel, and in
    ``balanced`` and ``fast`` ``ResidualUnitFn`` runs it on fp32 copies of
    the bf16 inputs and casts its output back to bf16.
    """
    check_mode(type(encoder), mode)
    front, tail = encoder.stages(lengths)
    with torch.no_grad():
        if mode in ("conformant", "high"):
            with allow_tf32() if mode == "high" else full_fp32():
                return tail(front(x)).float()
        bf16 = bf16_copies(encoder, None if mode == "fast" else ("conv_in.", "blocks."))
        with full_fp32():
            with parameters_as(encoder, bf16):
                y = front(x.to(torch.bfloat16))
                if mode == "fast":
                    return tail(y).float()
            return tail(y.float())


def tokenize(codec: Codec, wav, *, mode: str = "conformant"):
    """wav (B, T) -> token indices (Nq, B, Tf) int32, on the codec's device
    (Nq: ``config.num_codebooks``).

    ``mode`` sets the encoder's precision (``encode_in_mode``): conformant
    (fp32, the mode held to the JAX package's tokens), high, balanced
    (BigCodec only) or fast. The VQ (K1) runs fp32 with TF32 off in every
    mode (FSQ, which has no K1, is fp32 too). On the Conformer at 32 x 1 s
    the card waits on the host's kernel launches in every mode, so ``fast``
    is no faster than ``high`` there and flips more tokens (PERF.md).
    """
    wav = torch.as_tensor(wav, dtype=torch.float32, device=next(codec.parameters()).device)
    lat = encode_in_mode(codec.encoder, wav[:, None, :], mode)
    with full_fp32(), torch.no_grad():
        _, codes, _ = quantize(codec, lat)
    return codes
