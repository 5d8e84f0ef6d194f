"""Typed configuration: dataclasses with the JAX package's groups, names and
defaults, plus the YAML/JSON overlay loader, so the repo's ``configs/*.yaml``
load unchanged. The flagship is ``Config()``: BigCodec ngf 48, strides
2·2·2·5·5, 2-layer ResLSTM, factorized VQ 1024 -> 8 with 8192 codes, 16 kHz.
"""
from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional, Sequence, Tuple


@dataclass
class EncoderConfig:
    """codec_encoder group."""
    type: str = "bigcodec"  # bigcodec | conformer_stft
    out_channels: int = 1024
    # bigcodec fields
    ngf: int = 48
    use_rnn: bool = True
    rnn_bidirectional: bool = False
    rnn_num_layers: int = 2
    up_ratios: Tuple[int, ...] = (2, 2, 2, 5, 5)
    dilations: Tuple[int, ...] = (1, 3, 9)
    causal: bool = False
    antialias: bool = False
    # conformer_stft fields
    hop_length: int = 200
    n_fft: int = 800
    window_size: int = 800
    dim: int = 256
    n_layers: int = 6
    n_head: int = 8
    ffn_mult: int = 4
    conv_kernel_size: int = 31
    dropout: float = 0.1
    max_seq_len: int = 8192
    rope_theta: float = 10000.0
    ffn_type: str = "dense"  # dense | moe
    moe_experts: int = 4
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25


@dataclass
class DecoderConfig:
    """codec_decoder group; owns the quantizer settings."""
    type: str = "bigcodec"  # bigcodec | conformer_istft
    in_channels: int = 1024
    upsample_initial_channel: int = 1536
    ngf: int = 48
    use_rnn: bool = True
    rnn_bidirectional: bool = False
    rnn_num_layers: int = 2
    up_ratios: Tuple[int, ...] = (5, 5, 2, 2, 2)
    dilations: Tuple[int, ...] = (1, 3, 9)
    causal: bool = False
    antialias: bool = False
    # quantizer
    quantizer: str = "fvq"  # fvq | fsq | lfq | ema_vq | sim_vq | rpq
    fsq: bool = False  # reference-compat switch; True forces quantizer=fsq
    fsq_levels: Tuple[int, ...] = (4, 4, 4, 8)
    vq_num_quantizers: int = 1
    vq_commit_weight: float = 0.25
    vq_weight_init: bool = False
    vq_full_commit_loss: bool = False
    vq_cosine_sim: bool = False
    codebook_size: int = 8192
    codebook_dim: int = 8
    # conformer_istft fields
    hop_length: int = 200
    n_fft: int = 800
    window_size: int = 800
    dim: int = 256
    n_layers: int = 6
    n_head: int = 8
    ffn_mult: int = 4
    conv_kernel_size: int = 31
    dropout: float = 0.1
    max_seq_len: int = 8192
    rope_theta: float = 10000.0
    ffn_type: str = "dense"
    moe_experts: int = 4
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25


@dataclass
class MPDConfig:
    periods: Tuple[int, ...] = (2, 3, 5, 7, 11)
    max_downsample_channels: int = 512
    channels: int = 16
    channel_increasing_factor: int = 4


@dataclass
class STFTParams:
    fft_sizes: Tuple[int, ...] = (128, 256, 512, 1024, 2048)
    hop_sizes: Tuple[int, ...] = (32, 64, 128, 256, 512)
    win_lengths: Tuple[int, ...] = (128, 256, 512, 1024, 2048)
    window: str = "hann_window"


@dataclass
class MSTFTConfig:
    stft_params: STFTParams = field(default_factory=STFTParams)
    in_channels: int = 1
    out_channels: int = 1
    kernel_sizes: Tuple[int, ...] = (5, 3)
    channels: int = 32
    max_downsample_channels: int = 512
    downsample_scales: Tuple[int, ...] = (2, 2, 2)
    use_weight_norm: bool = True


@dataclass
class ModelConfig:
    codec_encoder: EncoderConfig = field(default_factory=EncoderConfig)
    codec_decoder: DecoderConfig = field(default_factory=DecoderConfig)
    mpd: MPDConfig = field(default_factory=MPDConfig)
    mstft: MSTFTConfig = field(default_factory=MSTFTConfig)


@dataclass
class Lambdas:
    lambda_disc: float = 1.0
    lambda_feat_match_loss: float = 1.0
    lambda_mel_loss: float = 15.0
    lambda_adv: float = 1.0
    lambda_stft_loss: float = 1.0
    lambda_semantic_loss: float = 5.0
    lambda_perceptual_loss: float = 0.0
    lambda_moe_load_balance: float = 0.01
    lambda_moe_router_z: float = 0.001


@dataclass
class OptimParams:
    lr: float = 1.0
    betas: Tuple[float, float] = (0.8, 0.9)
    weight_decay: float = 0.01
    eps: float = 1e-8


@dataclass
class ScheduleParams:
    warmup_step: int = 1000
    down_step: int = 500000
    min_lr: float = 1.0e-5
    max_lr: float = 1.0e-4


@dataclass
class TrainConfig:
    """Training settings: the step's (``train/step.py``) and the loop's
    (``train/loop.py``: steps, logging, validation, checkpoints). One
    process a rank under ``torchrun`` trains data parallel; ``fsdp`` also
    cuts the weights and AdamW moments at rest over the ranks and gathers
    them one block at a time in the step (``parallel/fsdp.py``).
    ``tensor_parallel`` (the Conformer's attention and SwiGLU weights, and
    the MoE's experts, split over the model devices) and
    ``pipeline_parallel`` (its layers in stages, ``pipeline_microbatches``
    microbatches, 0: one a stage; ``remat`` recomputes each layer) split
    the model over a process's model devices; one of the two at a time."""
    max_steps: int = 600000
    precision: str = "bf16"  # bf16 | fp32 | fp32_strict
    remat: Any = "auto"
    fsdp: bool = False
    tensor_parallel: int = 1
    pipeline_parallel: int = 1
    pipeline_microbatches: int = 0
    guard_nonfinite: bool = False
    seed: int = 1024
    lambdas: Lambdas = field(default_factory=Lambdas)
    use_mel_loss: bool = True
    use_feat_match_loss: bool = True
    use_stft_loss: bool = False
    use_semantic: bool = False
    concat_semantic: bool = True
    teacher_layer: int = 16
    teacher_layers: int = 24
    teacher_heads: int = 16
    teacher_intermediate: int = 4096
    stft_loss_params: STFTParams = field(default_factory=STFTParams)
    gen_optim_params: OptimParams = field(default_factory=OptimParams)
    disc_optim_params: OptimParams = field(default_factory=OptimParams)
    gen_grad_clip: float = 1.0
    disc_grad_clip: float = 1.0
    gen_schedule_params: ScheduleParams = field(default_factory=ScheduleParams)
    disc_schedule_params: ScheduleParams = field(default_factory=ScheduleParams)
    val_every_n_steps: int = 5000
    checkpoint_every_n_steps: int = 10000
    log_every_n_steps: int = 50
    num_sanity_val_steps: int = 4
    accumulate_grad_batches: int = 1


@dataclass
class DatasetSplit:
    filelist: str = ""
    batch_size: int = 32
    shuffle: bool = True
    min_audio_length: int = 16000  # -1 = full length
    log_idxs: Tuple[int, ...] = (0, 1, 2, 3)
    quality_metric_items: int = 4


@dataclass
class DatasetConfig:
    train: DatasetSplit = field(default_factory=lambda: DatasetSplit(shuffle=True))
    val: DatasetSplit = field(default_factory=lambda: DatasetSplit(shuffle=False))
    test: DatasetSplit = field(default_factory=lambda: DatasetSplit(
        batch_size=1, shuffle=False, min_audio_length=-1))
    sample_rate: int = 16000
    pad_to_multiple_of: int = 320


@dataclass
class Config:
    name: str = "bigcodec-tpu"
    log_dir: str = "runs"
    debug: bool = False
    resume_ckpt: Optional[str] = None
    ckpt: Optional[str] = None
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)


def resolve_remat(cfg: Config) -> bool:
    """``train.remat`` ("auto" | bool) as a bool. "auto" recomputes
    activations in the backward unless the step is bf16 and its micro-batch
    holds at most 32 x 16000 samples (the JAX package's calibration on a
    16 GB TPU v5e, kept so that both packages train the same way)."""
    r = cfg.train.remat
    if isinstance(r, bool):
        return r
    if r != "auto":
        raise ValueError(f"train.remat must be bool or 'auto', got {r!r}")
    crop = cfg.dataset.train.min_audio_length
    if crop is None or crop < 0:
        crop = cfg.dataset.sample_rate  # full-length clips: assume >= 1 s
    n_acc = max(int(cfg.train.accumulate_grad_batches), 1)
    work = cfg.dataset.train.batch_size * crop // n_acc
    return not (cfg.train.precision == "bf16" and work <= 32 * 16000)


def codec_hop(cfg) -> int:
    """Samples per token frame: the Conformer encoder's ``hop_length``, or
    the product of the BigCodec encoder's strides."""
    e = cfg.model.codec_encoder
    return e.hop_length if e.type == "conformer_stft" else math.prod(e.up_ratios)


def quantizer_kind(cfg) -> str:
    """The codec's quantizer: ``fsq`` when ``fsq: true`` (the reference's
    switch), else ``quantizer``."""
    d = cfg.model.codec_decoder
    return "fsq" if d.fsq else d.quantizer


def num_codebooks(cfg) -> int:
    """Codes per frame (the Nq of codes (Nq, B, Tf)): the factorized VQ's
    ``vq_num_quantizers``, 1 for the single-codebook quantizers (FSQ)."""
    return cfg.model.codec_decoder.vq_num_quantizers if quantizer_kind(cfg) == "fvq" else 1


def _merge(obj, overlay: dict):
    """Recursively apply a dict overlay onto a dataclass instance."""
    for k, v in overlay.items():
        if not hasattr(obj, k):
            raise KeyError(f"unknown config key {k!r} for {type(obj).__name__}")
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _merge(cur, v)
        else:
            if isinstance(cur, tuple) and isinstance(v, (list, tuple)):
                v = tuple(v)
            setattr(obj, k, v)
    return obj


def from_dict(data: dict) -> Config:
    """``Config()`` overlaid with a nested dict (a parsed YAML/JSON file, or
    ``dataclasses.asdict`` of a config with the same groups)."""
    return _merge(Config(), data)


def load_config(path: str | Path | None = None, overrides: Sequence[str] = ()) -> Config:
    """Build a Config from an optional YAML/JSON file plus dotted overrides
    (``a.b.c=value``, values parsed as JSON when possible)."""
    cfg = Config()
    if path is not None:
        text = Path(path).read_text()
        if str(path).endswith((".yaml", ".yml")):
            import yaml

            data = yaml.safe_load(text)
        else:
            data = json.loads(text)
        if data:
            _merge(cfg, data)
    for ov in overrides:
        key, _, raw = ov.partition("=")
        try:
            val = json.loads(raw)
        except json.JSONDecodeError:
            val = raw
        obj = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            obj = getattr(obj, p)
        _merge(obj, {parts[-1]: val})
    return cfg


def to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def save_config(cfg, path: str | Path):
    """``config.json`` of a run dir, as the JAX package writes it."""
    Path(path).write_text(json.dumps(to_dict(cfg), indent=2))
