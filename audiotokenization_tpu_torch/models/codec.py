"""Codec facade: encoder + quantizer + decoder.

Counterpart of ``audiotokenization_tpu/models/codec.py`` for the two codec
families, BigCodec (``models/bigcodec.py``) and the Conformer STFT/ISTFT
codec (``models/conformer.py``), each side built from its ``type``, with
the factorized VQ (``quantizers/factorized_vq.py``), FSQ
(``quantizers/fsq.py``; ``fsq: true``), the EMA-codebook VQ
(``quantizers/ema_vq.py``; ``quantizer: ema_vq``, ``vq_cosine_sim`` for
its cosine codebook) or LFQ (``quantizers/lfq.py``; ``quantizer: lfq``,
one bit per latent channel) as its quantizer. The serving path is
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
quantizer's. The quantizer is always fp32 with TF32 off.

The EMA quantizer's codebook is state, not a parameter: buffers of
``codec.quantizer``. ``quantize`` and ``forward`` never write them; in
training they return the updated state (``quantizer_state``), and the
train step writes it back after the generator's update. Its draws (the
rows that replace dead codes) come from ``draws(step, codes, vectors)``,
by default ``ema_draws``: a CPU generator seeded by the step.

A Conformer encoder with ``ffn_type: moe`` adds the router's aux losses to
``forward``'s output (``moe_aux_loss``: [load balance, router z, dropped
share], means over the MoE layers); tokenize and decode discard them.

``train.use_semantic`` adds the semantic-distillation branch
(``models/semantic.py``, the ``semantic`` submodule): the quantizer takes
``semantic_vq_in`` of the latents (fc_prior, over the teacher's encoded
layer concatenated with the latents under ``concat_semantic``, which then
needs the teacher's ``semantic_target`` to tokenize), decoding goes
through ``apply_fc_post_a``, and ``forward`` returns
``semantic_recon_loss``, the teacher's output coming from the batch's
``semantic_target`` or from a ``teacher`` run on its ``feats``. The
teacher is a module of its own, frozen, never in the codec's state; in
bf16 training it runs on bf16 copies of its weights.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, NamedTuple

import torch
from torch import nn

from ..config import Config, quantizer_kind, resolve_remat
from ..ops.moe import MoEFeedForward
from ..ops.params import cast_parameters, parameters_as
from ..parallel import dp
from ..parallel.fsdp import run_block
from . import bigcodec, conformer
from .quantizers import factorized_vq as fvq
from .quantizers import fsq
from .quantizers.ema_vq import EmaVQ, ema_vq_apply
from .quantizers.lfq import lfq_apply, lfq_indices_to_codes
from .semantic import (Semantic, align_frames, channels_linear, semantic_recon_loss,
                       teacher_target)
from .semantic import semantic_vq_in as _semantic_vq_in

QUANTIZERS = ("fvq", "fsq", "ema_vq", "lfq")


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
    """Raise ``ValueError`` for what the port does not build, as the JAX
    package raises: an unknown family or quantizer, an LFQ over 31 bits."""
    e, d = cfg.model.codec_encoder, cfg.model.codec_decoder
    for part, name, family in ((e, "encoder", ENCODERS), (d, "decoder", DECODERS)):
        if part.type not in family:
            raise ValueError(f"unknown {name} type {part.type!r}")
    quantizer = quantizer_kind(cfg)
    if quantizer not in QUANTIZERS:
        raise ValueError(f"unknown quantizer {quantizer}")
    if quantizer == "lfq" and d.in_channels > 31:
        raise ValueError(f"lfq: a code is in_channels = {d.in_channels} bits of an int32 index "
                         "(at most 31)")


def uses_moe(cfg: Config) -> bool:
    """Whether a side's config asks for the MoE feed-forward (as the JAX
    package's ``uses_moe``; only the Conformer encoder builds one,
    ``models/conformer.py``)."""
    return "moe" in (cfg.model.codec_encoder.ffn_type, cfg.model.codec_decoder.ffn_type)


class Codec(nn.Module):
    """Encoder (BigCodec or Conformer), quantizer (factorized residual VQ,
    FSQ, EMA VQ or LFQ, which has no parameters), decoder (BigCodec or
    Conformer) and, with ``train.use_semantic``, the semantic branch, with
    parameter and buffer names as in the JAX tree (``encoder``,
    ``quantizer``, ``decoder``, ``semantic``)."""

    def __init__(self, cfg: Config, *, generator: torch.Generator):
        super().__init__()
        check_config(cfg)
        e, d = cfg.model.codec_encoder, cfg.model.codec_decoder
        self.cfg = cfg
        self.encoder = ENCODERS[e.type].from_config(e, generator=generator)
        self.decoder = DECODERS[d.type].from_config(d, generator=generator)
        kind = quantizer_kind(cfg)
        if kind == "fsq":
            self.quantizer = fsq.FSQ(dim=d.in_channels, levels=d.fsq_levels, generator=generator)
        elif kind == "ema_vq":
            self.quantizer = EmaVQ(codebook_size=d.codebook_size, dim=d.in_channels,
                                   use_cosine_sim=d.vq_cosine_sim, generator=generator)
        elif kind == "lfq":
            self.quantizer = nn.Module()  # lookup-free: the codes are the latents' sign bits
        else:
            self.quantizer = fvq.ResidualVQ(
                num_quantizers=d.vq_num_quantizers, dim=d.in_channels,
                codebook_size=d.codebook_size, codebook_dim=d.codebook_dim,
                generator=generator)
        if cfg.train.use_semantic:
            self.semantic = Semantic(cfg, generator=generator)
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
    # the EMA quantizer's updated state (detached), None for the others
    quantizer_state: dict | None = None
    # fp32 mse of the semantic branch's reconstruction of the teacher, None without it
    semantic_recon_loss: torch.Tensor | None = None


def init_codec(cfg: Config, *, generator: torch.Generator, device="cuda") -> Codec:
    """A randomly initialised codec (weights drawn on the CPU from
    ``generator``), moved to ``device`` in eval mode (a trainer calls
    ``.train()``: cuDNN's LSTM has no backward in eval mode)."""
    device = resolve_device(device)
    return Codec(cfg, generator=generator).to(device).eval()


def encode(codec: Codec, wav, *, remat: bool = False, aux=None):
    """wav (B, T) -> latents (B, C, Tf). ``remat`` recomputes BigCodec's
    blocks, or the Conformer's layers, in the backward. ``aux``: a
    list the encoder's MoE layers append their aux losses to (an encoder
    without one takes none)."""
    if aux is None or not codec.encoder_moe:
        return codec.encoder(wav[:, None, :], remat=remat)
    return codec.encoder(wav[:, None, :], remat=remat, aux=aux)


def ema_draws(step: int, num_codes: int, num_vectors: int) -> dict:
    """The EMA quantizer's draws for one training step: ``expiry``, the
    (num_codes,) rows in [0, num_vectors) that replace dead codes, from a
    CPU generator seeded by ``step`` (the same step draws the same rows;
    the JAX package salts its key by the step the same way)."""
    g = torch.Generator().manual_seed(int(step))
    return {"expiry": torch.randint(0, num_vectors, (num_codes,), generator=g)}


def _salt(latents) -> int:
    """The JAX package's salt for a training call without a step."""
    return int(((latents[:, 0, 0].float() * 1e3).to(torch.int32) % 7919).sum())


def quantize(codec: Codec, latents, *, training: bool = False, step=None, draws=None,
             state=None, with_state: bool = False):
    """latents (B, C, Tf) -> (quantized (B, C, Tf), codes (Nq, B, Tf), loss (Nq,))
    [+ the EMA quantizer's updated state, with ``with_state``: detached, None
    for the other quantizers and in eval]. An fp32 island with TF32 off:
    bf16 latents go up to fp32, and the quantized latents come back in the
    latents' dtype; the loss stays fp32 (FSQ's is a zero of the latents'
    dtype: it has no commitment loss).

    EMA VQ: ``state`` (default: the codec's buffers) is the state read;
    training draws ``draws(step, codes, vectors)`` (default ``ema_draws``;
    without a step, salted by the latents as JAX does); the loss is the mean
    commitment. LFQ: the loss is mean(commit) + the entropy aux loss. In a
    data-parallel step (``parallel/dp.py``) the EMA statistics, its draws'
    rows and LFQ's batch entropy are the global batch's."""
    d = codec.cfg.model.codec_decoder
    kind = quantizer_kind(codec.cfg)
    qstate = None
    group = dp.active_group()  # a data-parallel step's ranks: global batch statistics
    with full_fp32():
        if kind == "fsq":
            zq, codes = fsq.fsq_apply(codec.quantizer, latents)
            codes = codes[None]
            loss = torch.zeros((1,), dtype=latents.dtype, device=latents.device)
        elif kind == "ema_vq":
            rows = None
            if training:  # rows of the global batch's vectors
                n_vectors = latents.shape[0] * latents.shape[2] * dp.world(group)
                rows = (draws or ema_draws)(_salt(latents) if step is None else step,
                                            d.codebook_size, n_vectors)
            res = ema_vq_apply(codec.quantizer.state() if state is None else state, latents,
                               training=training, commitment=d.vq_commit_weight, draws=rows,
                               use_cosine_sim=d.vq_cosine_sim, kmeans_init=False,
                               process_group=group if training else None)
            zq, codes, loss = res.quantized, res.indices[None], res.loss.mean()[None]
            if training:
                qstate = {k: v.detach() for k, v in res.state.items()}
        elif kind == "lfq":
            res = lfq_apply(latents, commit_weight=d.vq_commit_weight, training=training,
                            process_group=group if training else None)
            zq, codes = res.quantized, res.indices[None]
            loss = (res.commit_loss.mean() + res.entropy_aux_loss)[None]
        else:
            zq, codes, loss = fvq.residual_vq_apply(codec.quantizer, latents.float(),
                                                    num_quantizers=d.vq_num_quantizers,
                                                    commitment=d.vq_commit_weight,
                                                    training=training)
    out = (zq.to(latents.dtype), codes, loss)
    return out + (qstate,) if with_state else out


def decode(codec: Codec, quantized, *, remat: bool = False):
    """quantized latents (B, C, Tf) -> waveform (B, 1, Tf · hop); ``remat``
    as in ``encode``."""
    return codec.decoder(quantized, remat=remat)


def _semantic_target(codec: Codec, batch: Dict[str, Any], frames: int, teacher=None):
    """The teacher's output (B, 1024, ``frames``) for ``forward``: the
    batch's ``semantic_target``, or the ``teacher`` on its ``feats``,
    detached. Raises when neither is there."""
    if "semantic_target" in batch:
        return align_frames(batch["semantic_target"], frames).detach()
    if teacher is None or "feats" not in batch:
        raise ValueError("use_semantic needs the batch's semantic_target, or its feats and "
                         "a teacher")
    return teacher_target(teacher, batch["feats"], frames, codec.cfg.train.teacher_layer)


def forward(codec: Codec, batch: Dict[str, Any], *, training: bool = False,
            step=None, draws=None, quantizer_state=None, teacher=None) -> CodecOutput:
    """batch {"wav": (B, T)} -> CodecOutput: encode -> quantize -> decode,
    under ``train.precision`` (module docstring). In bf16 training the wav
    and every parameter but the quantizer's run as bf16 copies, and
    gradients reach the fp32 masters through the casts. ``training`` also
    turns on the commitment losses and, per ``resolve_remat``, per-block
    recomputation. ``step``, ``draws`` and ``quantizer_state`` go to the
    EMA quantizer (``quantize``), whose updated state comes back in
    ``quantizer_state``; the other quantizers draw nothing. The encoder's MoE
    layers' aux losses are averaged into ``moe_aux_loss`` (JAX
    ``codec.py:221-229``). With ``use_semantic`` the batch carries
    ``semantic_target`` (B, 1024, Tf) or ``feats`` (B, Tf', 160) for the
    frozen ``teacher`` (``models/w2v_bert.py``; on bf16 copies of its
    weights in bf16 training), and ``semantic_recon_loss`` is returned."""
    cfg = codec.cfg
    wav = batch["wav"]
    remat = training and resolve_remat(cfg)
    cast, teacher_cast = {}, {}
    if training and cfg.train.precision == "bf16":
        cast = cast_parameters(codec, torch.bfloat16, skip="quantizer")
        wav = wav.to(torch.bfloat16)
        batch = {k: (v.to(torch.bfloat16) if k in ("feats", "semantic_target") else v)
                 for k, v in batch.items()}
        if teacher is not None:
            teacher_cast = bf16_copies(teacher)
    aux = []
    sem_loss = None
    with precision_scope(cfg), parameters_as(codec, cast):
        latents = encode(codec, wav, remat=remat, aux=aux)
        if cfg.train.use_semantic:
            with torch.no_grad(), parameters_as(teacher, teacher_cast):
                target = _semantic_target(codec, batch, latents.shape[-1], teacher)
            latents = semantic_vq_in(codec, latents, target)
        zq, codes, vq_loss, qstate = run_block(
            codec.quantizer, quantize, codec, latents, training=training, step=step,
            draws=draws, state=quantizer_state, with_state=True)
        if cfg.train.use_semantic:
            sem_loss = semantic_recon_loss(codec.semantic, zq, target)
            zq = apply_fc_post_a(codec, zq)
        gen = decode(codec, zq, remat=remat)
    moe = None
    if aux:
        moe = torch.stack([sum(a[k] for a in aux) / len(aux)
                           for k in ("load_balance_loss", "router_z_loss", "dropped_frac")])
    return CodecOutput(gt_wav=wav[:, None, :], gen_wav=gen, vq_loss=vq_loss, vq_code=codes,
                       moe_aux_loss=moe, quantizer_state=qstate, semantic_recon_loss=sem_loss)


def codes_to_emb(codec: Codec, codes, *, proj: bool = True):
    """codes (B, Tf, Nq) -> decoder-input embeddings (B, C, Tf); FSQ, EMA VQ
    and LFQ read their one codebook's codes[..., 0] (``proj`` is the VQ's):
    the EMA codebook's ``embed`` rows, LFQ's ±1 bits."""
    kind = quantizer_kind(codec.cfg)
    if kind == "fsq":
        return fsq.fsq_codes_to_emb(codec.quantizer, codes[..., 0]).transpose(1, 2)
    if kind == "ema_vq":
        return codec.quantizer.embed[codes[..., 0].long()].transpose(1, 2)
    if kind == "lfq":
        bits = codec.cfg.model.codec_decoder.in_channels
        return lfq_indices_to_codes(codes[..., 0], codebook_dim=bits).transpose(1, 2)
    return fvq.residual_vq_codes_to_emb(codec.quantizer, codes, proj=proj).transpose(1, 2)


def apply_fc_post_a(codec: Codec, emb):
    """Semantic checkpoints decode fc_post_a(z_q): applied to decoder-input
    embeddings (B, C, Tf); without the semantic branch they pass through.
    Every decode from codes goes through it."""
    sem = getattr(codec, "semantic", None)
    return emb if sem is None else channels_linear(emb, sem.fc_post_a)


def semantic_vq_in(codec: Codec, latents, semantic_target=None, *, frames=None):
    """The quantizer's input of the latents (B, C, Tf): with
    ``use_semantic``, fc_prior(latents), or under ``concat_semantic``
    fc_prior(concat(SemanticEncoder(teacher), latents)) with the teacher's
    ``semantic_target`` (B, 1024, T') zero-padded or trimmed to Tf
    (``ValueError`` without it); else the latents. ``frames``: a ragged
    batch's frame counts (``utils/ragged.py``)."""
    if not codec.cfg.train.use_semantic:
        return latents
    return _semantic_vq_in(codec.semantic, codec.cfg, latents, semantic_target, frames=frames)


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


def tokenize(codec: Codec, wav, *, mode: str = "conformant", semantic_target=None):
    """wav (B, T) -> token indices (Nq, B, Tf) int32, on the codec's device
    (Nq: ``config.num_codebooks``). A semantic codec's latents go through
    ``semantic_vq_in`` first, fp32 with TF32 off in every mode (as the JAX
    package runs it at float32 precision); under ``concat_semantic`` it
    needs the teacher's ``semantic_target`` (B, 1024, Tf).

    ``mode`` sets the encoder's precision (``encode_in_mode``): conformant
    (fp32, the mode held to the JAX package's tokens), high, balanced
    (BigCodec only) or fast. The quantizer runs fp32 with TF32 off in every
    mode: the factorized VQ's search is K1; FSQ, the EMA VQ's distance GEMM
    and LFQ's sign bits run on stock ops, as they run on XLA in JAX. On the Conformer at 32 x 1 s
    the card waits on the host's kernel launches in every mode, so ``fast``
    is no faster than ``high`` there and flips more tokens (PERF.md).
    """
    wav = torch.as_tensor(wav, dtype=torch.float32, device=next(codec.parameters()).device)
    lat = encode_in_mode(codec.encoder, wav[:, None, :], mode)
    with torch.no_grad():
        if codec.cfg.train.use_semantic:
            with full_fp32():
                st = None if semantic_target is None else torch.as_tensor(
                    semantic_target, dtype=torch.float32, device=lat.device)
                lat = semantic_vq_in(codec, lat, st)
        _, codes, _ = quantize(codec, lat)
    return codes
