"""ECAPA-TDNN speaker embeddings, the speaker-verification suite's model
(counterpart of ``audiotokenization_tpu/models/ecapa_tdnn.py``, the
architecture of the reference's ``speaker_verification/models/
ecapa_tdnn.py``):

  features (log-mel fbank / MFCC / SSL layer-weighted) -> instance norm ->
  stem: Conv1d(k5, pad 2) -> ReLU -> BN
  layer1-3: SE-Res2 blocks (k3, dilation 2 / 3 / 4, scale 8)
     = 1x1 Conv-ReLU-BN -> Res2 (conv_i -> ReLU -> BN over the cascaded
       chunks, the LAST chunk appended unprocessed) -> 1x1 Conv-ReLU-BN ->
       SE -> + residual (a 1x1 shortcut where a checkpoint has one)
  cat(layer1, layer2, layer3) -> ReLU(Conv1d -> 1536)
  attentive statistics pool (tanh / softmax attention, weighted mean and
    std clamped at 1e-9; the global context only with
    ``global_context_att``) -> BN -> Linear(emb)

The op order is the reference's, which its checkpoints need: conv ->
ReLU -> BN (not conv -> BN -> ReLU), the unprocessed chunk last, the
residual after SE; BN runs in inference form on its running stats.
Variances: the instance norm's is the population one, the global
context's std the unbiased one (``torch.var``'s default in the
reference), each passed as ``correction=`` here.

``EcapaTdnn``'s state-dict keys are the JAX tree's paths
(``layer1.res2.convs.3.conv.w``, ``pool_bn.var``; BN's ``mean`` and
``var`` are buffers), so ``convert.params_from_jax`` maps an
``init_ecapa_tdnn`` tree onto it with no numeric change;
``convert_ecapa_from_torch`` maps a reference-layout state dict (e.g. a
UniSpeech SV release) and ``ecapa_from_state_dict`` builds the model of
either's shape. Used by ``cli/verification.py`` to score the cosine
similarity of two utterances, e.g. original speech against the codec's
reconstruction (the codec's speaker-preservation metric).
"""
from __future__ import annotations

import functools
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import Weights, conv1d, init_conv1d, init_linear, linear
from ..ops.stft import mel_filterbank, power, stft

SE_CHANNELS = 128     # the SE bottleneck (the reference's fixed width)
CAT_CHANNELS = 1536   # the aggregation conv's output, 512 x 3 in the reference


def instance_norm(x, *, eps: float = 1e-5):
    """nn.InstanceNorm1d (affine=False): per sample and channel over time,
    the population variance. x: (B, C, T)."""
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps)


@functools.lru_cache(maxsize=16)
def _htk_mels(sample_rate: int, n_fft: int, n_mels: int, fmax: float,
              device: torch.device) -> torch.Tensor:
    return torch.from_numpy(mel_filterbank(sample_rate=sample_rate, n_fft=n_fft, n_mels=n_mels,
                                           fmin=0.0, fmax=fmax, htk=True, norm=None)).to(device)


def _mel_power(wav, sample_rate: int, n_mels: int, n_fft: int, fmax: float):
    """HTK mel power spectrogram (B, n_mels, F): a Hann window of 25 ms
    centred in ``n_fft``, 10 ms hop, reflection padding."""
    s = stft(wav, n_fft=n_fft, hop_length=int(sample_rate * 0.01),
             win_length=int(sample_rate * 0.025))
    fb = _htk_mels(sample_rate, n_fft, n_mels, float(fmax), wav.device)
    return torch.einsum("mf,bft->bmt", fb, power(s))


def log_mel_fbank(wav, *, sample_rate: int = 16000, n_mels: int = 80, n_fft: int = 512):
    """torchaudio MelSpectrogram(n_fft 512, win 25 ms, hop 10 ms, HTK mels
    from 0 to sr // 2, no norm, power 2), + 1e-6, log. (B, T) -> (B, n_mels, F)."""
    return torch.log(_mel_power(wav, sample_rate, n_mels, n_fft, sample_rate // 2) + 1e-6)


@functools.lru_cache(maxsize=16)
def _dct_ortho(n_mfcc: int, n_mels: int, device: torch.device) -> torch.Tensor:
    """Orthonormal DCT-II (n_mfcc, n_mels): row 0 scaled by 1/√2."""
    n, k = np.arange(n_mels), np.arange(n_mfcc)[:, None]
    dct = np.cos(np.pi * (n[None] + 0.5) * k / n_mels) * np.sqrt(2.0 / n_mels)
    dct[0] *= 1.0 / np.sqrt(2.0)
    return torch.tensor(dct, dtype=torch.float32, device=device)


def mfcc(wav, *, sample_rate: int = 16000, n_mfcc: int = 40, n_mels: int = 128,
         n_fft: int = 512):
    """torchaudio MFCC(log_mels=False): the HTK mel power spectrogram (n_mels
    128 to sr/2) -> dB (10 log10, amin 1e-10, top_db 80 per batch item over
    mel and time) -> orthonormal DCT-II, + 1e-6. (B, T) -> (B, n_mfcc, F)."""
    mel = _mel_power(wav, sample_rate, n_mels, n_fft, sample_rate / 2.0)
    db = 10.0 * torch.log10(mel.clamp_min(1e-10))
    db = torch.maximum(db, db.amax(dim=(-2, -1), keepdim=True) - 80.0)
    return torch.einsum("km,bmt->bkt", _dct_ortho(n_mfcc, n_mels, wav.device), db) + 1e-6


def ssl_weighted_features(hidden_states, feature_weight):
    """The s3prl-style SSL frontend: the softmax-weighted sum of the hidden
    states (list of (B, T, D), weights (L,)) -> (B, D, T), + 1e-6."""
    hs = torch.stack(list(hidden_states), dim=0)
    w = torch.softmax(feature_weight.to(hs.dtype), dim=0)[:, None, None, None]
    return (w * hs).sum(0).transpose(1, 2) + 1e-6


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class BatchNorm(nn.Module):
    """BatchNorm1d's affine ``gamma`` / ``beta`` and its running ``mean`` /
    ``var`` (buffers), named as in the JAX tree."""

    def __init__(self, c: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(c))
        self.beta = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))


class ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, g: torch.Generator):
        super().__init__()
        self.conv = init_conv1d(cin, cout, k, generator=g)
        self.bn = BatchNorm(cout)


class _Res2(nn.Module):
    def __init__(self, width: int, scale: int, g):
        super().__init__()
        self.convs = nn.ModuleList(ConvBN(width, width, 3, g) for _ in range(scale - 1))


class _SE(nn.Module):
    def __init__(self, c: int, se: int, g):
        super().__init__()
        self.fc1 = init_linear(c, se, generator=g)
        self.fc2 = init_linear(se, c, generator=g)


class SERes2Block(nn.Module):
    def __init__(self, c: int, scale: int, se: int, g, shortcut: bool = False):
        super().__init__()
        self.conv1 = ConvBN(c, c, 1, g)
        self.res2 = _Res2(c // scale, scale, g)
        self.conv2 = ConvBN(c, c, 1, g)
        self.se = _SE(c, se, g)
        if shortcut:
            self.shortcut = init_conv1d(c, c, 1, generator=g)


class _Pool(nn.Module):
    def __init__(self, c_in: int, att: int, c: int, g):
        super().__init__()
        self.att1 = init_conv1d(c_in, att, 1, generator=g)
        self.att2 = init_conv1d(att, c, 1, generator=g)


class EcapaTdnn(nn.Module):
    """ECAPA-TDNN's parameters under the JAX tree's names; ``scale`` and
    ``global_context_att`` ride along. ``feature_layers``: the SSL
    frontend's layer weights ``feature_weight`` (L,), which a reference SSL
    checkpoint carries."""

    def __init__(self, n_mels: int = 80, channels: int = 512, emb_dim: int = 192,
                 scale: int = 8, attention_channels: int = 128,
                 global_context_att: bool = False, *, generator: torch.Generator,
                 shortcut=(False, False, False), se_channels: int = SE_CHANNELS,
                 cat_channels: int = CAT_CHANNELS, feature_layers: int | None = None):
        super().__init__()
        g = generator
        self.scale, self.global_context_att = scale, global_context_att
        self.stem = ConvBN(n_mels, channels, 5, g)
        self.layer1, self.layer2, self.layer3 = (
            SERes2Block(channels, scale, se_channels, g, s) for s in shortcut)
        self.agg = init_conv1d(channels * 3, cat_channels, 1, generator=g)
        att_in = cat_channels * 3 if global_context_att else cat_channels
        self.pool = _Pool(att_in, attention_channels, cat_channels, g)
        self.pool_bn = BatchNorm(cat_channels * 2)
        self.fc = init_linear(cat_channels * 2, emb_dim, generator=g)
        if feature_layers is not None:
            self.feature_weight = nn.Parameter(torch.zeros(feature_layers))


def init_ecapa_tdnn(generator: torch.Generator, *, n_mels: int = 80, channels: int = 512,
                    emb_dim: int = 192, scale: int = 8, attention_channels: int = 128,
                    global_context_att: bool = False, device="cuda") -> EcapaTdnn:
    """A random ECAPA-TDNN (torch's default conv / linear init drawn on the
    CPU from ``generator``, BN at identity), frozen, in eval mode on
    ``device`` (raises without a card unless ``device="cpu"``)."""
    from .codec import resolve_device

    device = resolve_device(device)
    model = EcapaTdnn(n_mels, channels, emb_dim, scale, attention_channels,
                      global_context_att, generator=generator)
    return model.requires_grad_(False).eval().to(device)


def ecapa_from_state_dict(sd: Mapping[str, torch.Tensor], *, device="cuda") -> EcapaTdnn:
    """An ``EcapaTdnn`` of the shape of ``sd`` (the port's keys: a saved
    ``state_dict()``, ``params_from_jax`` of a JAX tree, or
    ``convert_ecapa_from_torch``'s output), loaded with it, frozen, in eval
    mode on ``device``. A conv or linear layer without a bias in ``sd`` is
    built without one."""
    from .codec import resolve_device

    device = resolve_device(device)
    shape = {k: tuple(v.shape) for k, v in sd.items()}
    channels, n_mels, _ = shape["stem.conv.w"]
    cat = shape["agg.w"][0]
    scale = 1 + sum(1 for k in sd if k.startswith("layer1.res2.convs.") and k.endswith(".conv.w"))
    model = EcapaTdnn(
        n_mels, channels, shape["fc.w"][0], scale, shape["pool.att1.w"][0],
        shape["pool.att1.w"][1] == 3 * cat, generator=torch.Generator().manual_seed(0),
        shortcut=tuple(f"layer{i}.shortcut.w" in sd for i in (1, 2, 3)),
        se_channels=shape["layer1.se.fc1.w"][0], cat_channels=cat,
        feature_layers=shape["feature_weight"][0] if "feature_weight" in sd else None)
    for name, m in model.named_modules():
        if isinstance(m, Weights) and "b" in m._parameters and f"{name}.b" not in sd:
            del m.b
    model.load_state_dict(sd)
    return model.requires_grad_(False).eval().to(device)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _bias(p: Weights):
    return p._parameters.get("b")


def _bn(p: BatchNorm, x, *, eps: float = 1e-5):
    """BatchNorm1d in inference form. x: (B, C, T) or (B, C)."""
    shape = (1, -1, 1) if x.ndim == 3 else (1, -1)
    inv = torch.rsqrt(p.var + eps)
    return (x - p.mean.reshape(shape)) * (inv * p.gamma).reshape(shape) + p.beta.reshape(shape)


def _conv_relu_bn(p: ConvBN, x, *, dilation: int = 1, padding: int | None = None):
    w = p.conv.w
    if padding is None:
        padding = (w.shape[-1] - 1) // 2 * dilation
    return _bn(p.bn, F.relu(conv1d(x, w, _bias(p.conv), padding=padding, dilation=dilation)))


def _res2_convs(p: _Res2, x, *, scale: int, dilation: int):
    """The cascade over the first scale - 1 chunks, the last appended
    unprocessed."""
    if x.shape[1] % scale:
        raise ValueError(f"{x.shape[1]} channels do not split into {scale} chunks")
    chunks = x.split(x.shape[1] // scale, dim=1)
    outs, sp = [], None
    for i, conv in enumerate(p.convs):
        sp = chunks[i] if sp is None else sp + chunks[i]
        sp = _conv_relu_bn(conv, sp, dilation=dilation)
        outs.append(sp)
    outs.append(chunks[scale - 1])
    return torch.cat(outs, dim=1)


def _se_block(p: _SE, x):
    s = F.relu(linear(x.mean(-1), p.fc1))
    return x * torch.sigmoid(linear(s, p.fc2))[:, :, None]


def _se_res2_block(p: SERes2Block, x, *, scale: int, dilation: int):
    residual = x
    if hasattr(p, "shortcut"):
        residual = conv1d(x, p.shortcut.w, _bias(p.shortcut))
    out = _conv_relu_bn(p.conv1, x)
    out = _res2_convs(p.res2, out, scale=scale, dilation=dilation)
    out = _se_block(p.se, _conv_relu_bn(p.conv2, out))
    return out + residual


def _attentive_stats_pool(p: _Pool, x, *, global_context_att: bool):
    """(B, C, T) -> (B, 2C): attention-weighted mean and std."""
    if global_context_att:
        mean = x.mean(-1, keepdim=True).expand_as(x)
        std = torch.sqrt(x.var(-1, keepdim=True, correction=1) + 1e-10).expand_as(x)
        x_in = torch.cat([x, mean, std], dim=1)
    else:
        x_in = x
    att = torch.tanh(conv1d(x_in, p.att1.w, _bias(p.att1)))
    att = torch.softmax(conv1d(att, p.att2.w, _bias(p.att2)), dim=-1)
    mu = (x * att).sum(-1)
    sg = torch.sqrt(((x * x * att).sum(-1) - mu * mu).clamp_min(1e-9))
    return torch.cat([mu, sg], dim=1)


def ecapa_tdnn_embed(model: EcapaTdnn, feats, *, normalize_input: bool = True):
    """Raw frontend features (B, n_mels, T) -> embeddings (B, emb_dim); the
    instance norm is applied here unless ``normalize_input`` is False."""
    x = instance_norm(feats) if normalize_input else feats
    s = model.scale
    out1 = _conv_relu_bn(model.stem, x, padding=2)
    out2 = _se_res2_block(model.layer1, out1, scale=s, dilation=2)
    out3 = _se_res2_block(model.layer2, out2, scale=s, dilation=3)
    out4 = _se_res2_block(model.layer3, out3, scale=s, dilation=4)
    x = F.relu(conv1d(torch.cat([out2, out3, out4], dim=1), model.agg.w, _bias(model.agg)))
    pooled = _attentive_stats_pool(model.pool, x, global_context_att=model.global_context_att)
    return linear(_bn(model.pool_bn, pooled), model.fc)


def extract_features(wav, *, feat_type: str = "fbank", sample_rate: int = 16000,
                     ssl_fn=None, feature_weight=None):
    """The frontend: 'fbank' | 'mfcc' | 'ssl' (``ssl_fn``: wav (B, T) ->
    list of (B, T', D) hidden states, weighted by ``feature_weight``).
    Raw features; ``ecapa_tdnn_embed`` applies the instance norm."""
    if feat_type == "fbank":
        return log_mel_fbank(wav, sample_rate=sample_rate)
    if feat_type == "mfcc":
        return mfcc(wav, sample_rate=sample_rate)
    if feat_type == "ssl":
        if ssl_fn is None or feature_weight is None:
            raise ValueError("feat_type='ssl' needs ssl_fn and feature_weight")
        return ssl_weighted_features(ssl_fn(wav), feature_weight)
    raise ValueError(f"unknown feat_type {feat_type!r}")


def speaker_similarity(model: EcapaTdnn, wav_a, wav_b, *, sample_rate: int = 16000,
                       feat_type: str = "fbank", ssl_fn=None, feature_weight=None):
    """Cosine similarity (B,) of the speaker embeddings of ``wav_a`` and
    ``wav_b`` (B, T), in fp32 with TF32 off (the frontend included)."""
    from .codec import full_fp32

    kw = dict(feat_type=feat_type, sample_rate=sample_rate, ssl_fn=ssl_fn,
              feature_weight=feature_weight)
    with torch.no_grad(), full_fp32():
        ea = ecapa_tdnn_embed(model, extract_features(wav_a, **kw))
        eb = ecapa_tdnn_embed(model, extract_features(wav_b, **kw))
    ea = ea / torch.linalg.vector_norm(ea, dim=-1, keepdim=True)
    eb = eb / torch.linalg.vector_norm(eb, dim=-1, keepdim=True)
    return (ea * eb).sum(-1)


# ---------------------------------------------------------------------------
# Reference checkpoints
# ---------------------------------------------------------------------------

def convert_ecapa_from_torch(sd: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A reference ``ECAPA_TDNN`` state dict (tensors or numpy arrays) ->
    ``EcapaTdnn``'s state dict (CPU tensors, copied). An SSL checkpoint's
    ``feature_weight`` is kept; ``feature_extract.*`` (the frozen torch
    upstream) is not: the upstream loads on its own (``models/wav2vec2.py::
    load_ssl_upstream``)."""
    out: dict[str, torch.Tensor] = {}

    def t(k):
        v = sd[k]
        return (v.detach().to("cpu").clone() if torch.is_tensor(v)
                else torch.from_numpy(np.array(v, copy=True)))

    def conv(ours, theirs):
        out[f"{ours}.w"] = t(theirs + ".weight")
        if theirs + ".bias" in sd:
            out[f"{ours}.b"] = t(theirs + ".bias")

    def bn(ours, theirs):
        for a, b in (("gamma", "weight"), ("beta", "bias"), ("mean", "running_mean"),
                     ("var", "running_var")):
            out[f"{ours}.{a}"] = t(f"{theirs}.{b}")

    def crb(ours, theirs):
        conv(ours + ".conv", theirs + ".conv")
        bn(ours + ".bn", theirs + ".bn")

    conv("stem.conv", "layer1.conv")
    bn("stem.bn", "layer1.bn")
    for ours, theirs in (("layer1", "layer2"), ("layer2", "layer3"), ("layer3", "layer4")):
        crb(ours + ".conv1", theirs + ".Conv1dReluBn1")
        i = 0
        while f"{theirs}.Res2Conv1dReluBn.convs.{i}.weight" in sd:
            conv(f"{ours}.res2.convs.{i}.conv", f"{theirs}.Res2Conv1dReluBn.convs.{i}")
            bn(f"{ours}.res2.convs.{i}.bn", f"{theirs}.Res2Conv1dReluBn.bns.{i}")
            i += 1
        crb(ours + ".conv2", theirs + ".Conv1dReluBn2")
        conv(ours + ".se.fc1", theirs + ".SE_Connect.linear1")
        conv(ours + ".se.fc2", theirs + ".SE_Connect.linear2")
        if theirs + ".shortcut.weight" in sd:
            conv(ours + ".shortcut", theirs + ".shortcut")
    conv("agg", "conv")
    conv("pool.att1", "pooling.linear1")
    conv("pool.att2", "pooling.linear2")
    bn("pool_bn", "bn")
    conv("fc", "linear")
    if "feature_weight" in sd:
        out["feature_weight"] = t("feature_weight")
    return out
