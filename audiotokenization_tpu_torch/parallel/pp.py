"""Pipeline parallelism (GPipe) for the Conformer backbone, serving
(counterpart of ``audiotokenization_tpu/parallel/pp.py``).

The layer stack is split into P contiguous stages, one a device
(``make_pipe_mesh``), the batch into M microbatches, and the activations
go stage to stage as copies between devices in the GPipe schedule: M + P
- 1 ticks, at tick t stage s runs its layers on microbatch t - s. Each
microbatch meets the same layers in the same order and dtype as the
sequential backbone, so pipelined tokens equal one-device ``tokenize``.

``pp_backbone_fn`` is the ``backbone_fn`` hook of
``models/conformer.py::conformer_encode`` / ``conformer_decode``;
``pp_tokenize`` pipelines the encoder, ``pp_synthesize`` the decoder.
Each stage runs the layers of the codec's copy on its device (one copy a
distinct device, ``mesh.Replicas``); the stream before and after the
backbone runs on the first stage's device. A device may repeat.

Training (``train.pipeline_parallel``, ``train/step.py``): ``pp_place``
moves each stage's layers of the trained codec to the stage's device (the
rest of the codec and the discriminators stay on the first), so the
stages are the optimizer's own parameters and the state dict keeps the
one-card layout. Inside ``pp_train_context`` the Conformer's
``maybe_pp_backbone`` hook runs both backbones as GPipe pipelines under
autograd: each microbatch's copies between devices carry its gradient
back, and ``train.remat`` recomputes each layer in the backward
(``torch.utils.checkpoint``, as JAX wraps the layer in
``jax.checkpoint``). Outside the context a backbone whose layers sit on
several devices runs them in order, its activations following the layers
(``ops/transformer.py::conformer_backbone``): evaluation gives the
one-device numbers.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from .mesh import Replicas, data_devices


_local = threading.local()


def make_pipe_mesh(n_stages: int, devices=None, *, device="cuda") -> list:
    """The first ``n_stages`` of ``devices`` (``mesh.data_devices``), one
    a stage."""
    devices = data_devices(devices, device=device)
    if len(devices) < n_stages:
        raise ValueError(f"{n_stages} stages > {len(devices)} devices")
    return devices[:n_stages]


def validate_pp(cfg, n_pipe: int, which=("encoder", "decoder")) -> None:
    """Fail fast on a non-Conformer side, a layer count the stages do not
    divide, or the MoE feed-forward; ``which``: the sides pipelined."""
    sides = []
    if "encoder" in which and cfg.model.codec_encoder.type == "conformer_stft":
        sides.append(("encoder", cfg.model.codec_encoder))
    if "decoder" in which and cfg.model.codec_decoder.type == "conformer_istft":
        sides.append(("decoder", cfg.model.codec_decoder))
    if not sides:
        raise ValueError(
            "pipeline_parallel>1 requires a conformer encoder or decoder; "
            "the BigCodec conv family scales via data/FSDP/sequence "
            "parallelism (parallel/mesh.py, parallel/sp.py)")
    for side, m in sides:
        if m.n_layers % n_pipe:
            raise ValueError(f"{side}: n_layers={m.n_layers} not divisible by "
                             f"pipeline_parallel={n_pipe}")
        if getattr(m, "ffn_type", "dense") == "moe":
            raise ValueError(f"{side}: ffn_type: moe is not composed with "
                             "pipeline_parallel yet; shard experts via "
                             "train.tensor_parallel instead")


def stack_stage_params(backbone, n_stages: int) -> list:
    """A backbone's layers as ``n_stages`` lists: stage s holds layers
    [s·L/P, (s+1)·L/P)."""
    layers = list(backbone.layers)
    if len(layers) % n_stages:
        raise ValueError(f"{len(layers)} layers not divisible by {n_stages} stages")
    per = len(layers) // n_stages
    return [layers[s * per:(s + 1) * per] for s in range(n_stages)]


def pp_backbone_fn(stages, backbone, *, n_micro: int | None = None, remat: bool = False):
    """A (h, backbone) -> h replacement for ``conformer_backbone`` (h (B, T,
    C)) that runs ``stages`` (each stage's layers, on its device) as a GPipe
    pipeline of ``n_micro`` microbatches (default: one a stage; B must
    divide by it). ``backbone``: the settings the layers run with (heads,
    RoPE, order, causality); the weights are the stages'. The result comes
    back to h's device. Differentiable; ``remat``: each layer's activations
    recomputed in the backward."""
    from ..ops.params import checkpointed
    from ..ops.transformer import conformer_layer

    P = len(stages)
    devices = [next(stage[0].parameters()).device for stage in stages]

    def layer_fn(x, layer, cos, sin):
        kw = dict(n_head=backbone.n_head, conv_first=backbone.conv_first,
                  causal=backbone.causal)
        if remat:
            return checkpointed(lambda x, p: conformer_layer(x, p, cos, sin, **kw), layer, x)
        return conformer_layer(x, layer, cos, sin, **kw)

    def run(h, _backbone=None):
        B, T, C = h.shape
        if T > backbone.max_seq_len:
            raise ValueError(f"{T} frames exceed max_seq_len={backbone.max_seq_len} "
                             "(the RoPE table)")
        M = n_micro or P
        if B % M:
            raise ValueError(f"batch {B} not divisible by {M} microbatches")
        mbs = h.chunk(M)
        tables = [tuple(t[:T] for t in backbone.rope(dev)) for dev in devices]
        results, carry = [None] * M, [None] * P
        for t in range(M + P - 1):
            made = [None] * P
            for s in range(P):
                j = t - s
                if not 0 <= j < M:
                    continue
                x = (mbs[j] if s == 0 else carry[s - 1]).to(devices[s])
                for layer in stages[s]:
                    x = layer_fn(x, layer, *tables[s])
                made[s] = x
                if s == P - 1:
                    results[j] = x
            carry = made
        return torch.cat([r.to(h.device) for r in results])

    return run


@contextlib.contextmanager
def pp_train_context(devices, n_micro: int | None = None, *, remat: bool = False):
    """Within the body, on this thread, the Conformer backbones whose layers
    ``pp_place`` put on ``devices`` run as GPipe pipelines of ``n_micro``
    microbatches (default one a stage), differentiable
    (``maybe_pp_backbone``)."""
    prev = getattr(_local, "ctx", None)
    _local.ctx = (list(devices), n_micro, remat)
    try:
        yield
    finally:
        _local.ctx = prev


def maybe_pp_backbone(backbone):
    """The pipeline ``backbone_fn`` of ``backbone`` inside a
    ``pp_train_context``, its stages the backbone's own layers; else None."""
    ctx = getattr(_local, "ctx", None)
    if ctx is None:
        return None
    devices, n_micro, remat = ctx
    return pp_backbone_fn(stack_stage_params(backbone, len(devices)), backbone,
                          n_micro=n_micro or len(devices), remat=remat)


def pp_place(codec, cfg, devices) -> None:
    """Move stage s's layers of each Conformer backbone of ``codec`` to
    ``devices[s]``, in place (the parameters keep their identity); raises as
    ``validate_pp``."""
    validate_pp(cfg, len(devices))
    for side in ("encoder", "decoder"):
        backbone = getattr(getattr(codec, side), "backbone", None)
        if backbone is None:
            continue
        for layers, dev in zip(stack_stage_params(backbone, len(devices)), devices):
            for layer in layers:
                layer.to(torch.device(dev))


def _stages(codec, devices, side: str):
    """Each stage's layers of ``side`` (encoder or decoder), from the codec's
    copy on the stage's device, and the first stage's copy of the codec."""
    replicas = Replicas()
    copies = [replicas(codec, dev) for dev in devices]
    stages = [stack_stage_params(getattr(c, side).backbone, len(devices))[s]
              for s, c in enumerate(copies)]
    return stages, copies[0]


def pp_tokenize(codec, cfg, devices, *, n_micro: int | None = None):
    """``run(wav)``: wav (B, T) -> codes (Nq, B, T / hop) on the first
    stage's device, the Conformer encoder's backbone pipelined over
    ``devices`` (``make_pipe_mesh``); conformant (fp32, TF32 off), token
    for token one-device ``tokenize``."""
    from ..models.codec import full_fp32, quantize, semantic_vq_in
    from ..models.conformer import conformer_encode

    if cfg.model.codec_encoder.type != "conformer_stft":
        raise ValueError("pipeline parallelism targets the conformer family; "
                         "BigCodec scales via dp/fsdp/sp (parallel/)")
    validate_pp(cfg, len(devices), which=("encoder",))
    stages, c = _stages(codec, devices, "encoder")
    bb = pp_backbone_fn(stages, c.encoder.backbone, n_micro=n_micro)

    def run(wav):
        wav = torch.as_tensor(wav, dtype=torch.float32, device=devices[0])
        with torch.no_grad(), full_fp32():
            lat = conformer_encode(c.encoder, wav[:, None, :], backbone_fn=bb)
            return quantize(c, semantic_vq_in(c, lat))[1]

    return run


def pp_synthesize(codec, cfg, devices, *, n_micro: int | None = None):
    """``run(codes)``: codes (Nq, B, Tf) -> waveforms (B, Tf · hop) on the
    first stage's device, the Conformer decoder's backbone pipelined over
    ``devices``; codes_to_emb -> apply_fc_post_a -> decode in fp32 with
    TF32 off, equal to one-device decode to fp32 rounding."""
    from ..models.codec import apply_fc_post_a, codes_to_emb, full_fp32
    from ..models.conformer import conformer_decode

    if cfg.model.codec_decoder.type != "conformer_istft":
        raise ValueError("pipeline parallelism targets the conformer family")
    validate_pp(cfg, len(devices), which=("decoder",))
    stages, c = _stages(codec, devices, "decoder")
    bb = pp_backbone_fn(stages, c.decoder.backbone, n_micro=n_micro)

    def run(codes):
        codes = torch.as_tensor(codes, device=devices[0])
        with torch.no_grad(), full_fp32():
            emb = apply_fc_post_a(c, codes_to_emb(c, codes.permute(1, 2, 0)))
            return conformer_decode(c.decoder, emb, backbone_fn=bb)[:, 0, :]

    return run
