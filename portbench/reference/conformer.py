"""Plain reference of the Conformer STFT encoder (the reference's
config1/model/base.yaml), one utterance at a time, fp32:

STFT (hann n_fft, (win - hop) / 2 zeros each side, no centring) ->
cat(re, im) -> 1x1 input_proj -> RMS norm -> layers of {x + conv module,
x + SwiGLU, x + attention, x + SwiGLU}, each on the RMS-normed input ->
RMS norm (-> 1x1 output_proj where out_channels != dim).

Attention: fused qkv rows [q | k | v], a weightless RMS norm on q and k,
RoPE over the interleaved pairs (x[2i], x[2i+1]) with angles taken in
float64, softmax(q k^T / sqrt(D)) v in one product. Conv module: pw1 -> GLU
-> depthwise k conv, zero padding (k - 1) / 2 -> RMS norm -> SiLU -> pw2.
SwiGLU: w2(silu(w1 x) * w3 x), hidden 256 * ceil(2 * dim * mult / 3 / 256).

Parameter names follow the program's state dict. Imports torch and numpy only.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .common import Spec, hann, rms_norm, vq_specs, wn_specs, wn_weight


def swiglu_hidden(dim, mult):
    return 256 * -(-int(2 * dim * mult / 3) // 256)


def _layer_specs(pre, c):
    dim, k = c["dim"], c["conv_kernel_size"]
    hid = swiglu_hidden(dim, c["ffn_mult"])
    out = [Spec(f"{pre}.{n}", (dim,), "norm")
           for n in ("attn_norm", "conv_norm", "ffn1_norm", "ffn2_norm")]
    for f in ("ffn1", "ffn2"):
        out += [Spec(f"{pre}.{f}.w1.w", (hid, dim), "fan_in"),
                Spec(f"{pre}.{f}.w2.w", (dim, hid), "fan_in"),
                Spec(f"{pre}.{f}.w3.w", (hid, dim), "fan_in")]
    out += [Spec(f"{pre}.attn.qkv.w", (3 * dim, dim), "fan_in"),
            Spec(f"{pre}.attn.out.w", (dim, dim), "fan_in"),
            Spec(f"{pre}.conv.norm", (dim,), "norm"),
            Spec(f"{pre}.conv.pw1.w", (2 * dim, dim, 1), "fan_in"),
            Spec(f"{pre}.conv.pw1.b", (2 * dim,), "bias"),
            Spec(f"{pre}.conv.dw.w", (dim, 1, k), "fan_in"),
            Spec(f"{pre}.conv.dw.b", (dim,), "bias"),
            Spec(f"{pre}.conv.pw2.w", (dim, dim, 1), "fan_in"),
            Spec(f"{pre}.conv.pw2.b", (dim,), "bias")]
    return out


def param_specs(cfg):
    """Every tensor of the codec: (name, shape, init)."""
    e, d = cfg["model"]["codec_encoder"], cfg["model"]["codec_decoder"]
    nf = 2 * (e["n_fft"] // 2 + 1)
    out = [Spec("encoder.input_proj.w", (e["dim"], nf, 1), "fan_in"),
           Spec("encoder.input_proj.b", (e["dim"],), "bias"),
           Spec("encoder.input_norm", (e["dim"],), "norm"),
           Spec("encoder.norm", (e["dim"],), "norm")]
    for l in range(e["n_layers"]):
        out += _layer_specs(f"encoder.backbone.layers.{l}", e)
    if e["out_channels"] != e["dim"]:
        out += wn_specs("encoder.output_proj", (e["out_channels"], e["dim"], 1))
    if d["in_channels"] != d["dim"]:
        out += wn_specs("decoder.input_proj", (d["dim"], d["in_channels"], 1))
    for l in range(d["n_layers"]):
        out += _layer_specs(f"decoder.backbone.layers.{l}", d)
    out += [Spec("decoder.norm", (d["dim"],), "norm"),
            Spec("decoder.head_out.w", (d["n_fft"] + 2, d["dim"]), "fan_in"),
            Spec("decoder.head_out.b", (d["n_fft"] + 2,), "bias")]
    return out + vq_specs(cfg)


def _rope(T, head_dim, theta, device):
    freqs = 1.0 / (theta ** (np.arange(0, head_dim, 2)[: head_dim // 2] / head_dim))
    ang = np.outer(np.arange(T, dtype=np.float64), freqs)
    return (torch.tensor(np.cos(ang), dtype=torch.float32, device=device),
            torch.tensor(np.sin(ang), dtype=torch.float32, device=device))


def _rotate(x, cos, sin):
    """x (T, H, D): each pair (x[2i], x[2i+1]) rotated by its position's angle."""
    xe, xo = x[..., 0::2], x[..., 1::2]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.stack([xe * c - xo * s, xe * s + xo * c], dim=-1).reshape(x.shape)


def _attention(x, P, pre, n_head, cos, sin):
    T, C = x.shape
    q, k, v = (x @ P[f"{pre}.qkv.w"].T).reshape(T, 3, n_head, C // n_head).unbind(1)
    q, k = _rotate(rms_norm(q), cos, sin), _rotate(rms_norm(k), cos, sin)
    q, k, v = (t.transpose(0, 1) for t in (q, k, v))  # (H, T, D)
    p = torch.softmax((q @ k.transpose(1, 2)) * (C // n_head) ** -0.5, dim=-1)
    return (p @ v).transpose(0, 1).reshape(T, C) @ P[f"{pre}.out.w"].T


def _swiglu(x, P, pre):
    return (F.silu(x @ P[f"{pre}.w1.w"].T) * (x @ P[f"{pre}.w3.w"].T)) @ P[f"{pre}.w2.w"].T


def _conv_module(x, P, pre):
    a, b = (x @ P[f"{pre}.pw1.w"][..., 0].T + P[f"{pre}.pw1.b"]).chunk(2, dim=-1)
    y = (a * torch.sigmoid(b)).T[None]  # (1, C, T)
    w = P[f"{pre}.dw.w"]
    y = F.conv1d(y, w, P[f"{pre}.dw.b"], padding=(w.shape[-1] - 1) // 2,
                 groups=w.shape[0])[0].T
    return F.silu(rms_norm(y, P[f"{pre}.norm"])) @ P[f"{pre}.pw2.w"][..., 0].T + P[f"{pre}.pw2.b"]


def _stft(wav, n_fft, hop, win):
    pad = (win - hop) // 2
    x = F.pad(wav, (pad, pad))
    return torch.stft(x, n_fft, hop_length=hop, win_length=n_fft, window=hann(win, wav.device),
                      center=False, return_complex=True)


def encode(P, cfg, wavs):
    """wavs: a list of (T,) fp32 utterances, each T a multiple of the hop ->
    a list of latents (out_channels, T / hop), each utterance computed alone."""
    e = cfg["model"]["codec_encoder"]
    out = []
    for wav in wavs:
        spec = _stft(wav, e["n_fft"], e["hop_length"], e["window_size"])
        feats = torch.cat([spec.real, spec.imag], dim=0).T  # (T, 2F)
        x = feats @ P["encoder.input_proj.w"][..., 0].T + P["encoder.input_proj.b"]
        x = rms_norm(x, P["encoder.input_norm"])
        cos, sin = _rope(x.shape[0], e["dim"] // e["n_head"], float(e["rope_theta"]), x.device)
        for l in range(e["n_layers"]):
            pre = f"encoder.backbone.layers.{l}"
            x = x + _conv_module(rms_norm(x, P[f"{pre}.conv_norm"]), P, f"{pre}.conv")
            x = x + _swiglu(rms_norm(x, P[f"{pre}.ffn1_norm"]), P, f"{pre}.ffn1")
            x = x + _attention(rms_norm(x, P[f"{pre}.attn_norm"]), P, f"{pre}.attn",
                               e["n_head"], cos, sin)
            x = x + _swiglu(rms_norm(x, P[f"{pre}.ffn2_norm"]), P, f"{pre}.ffn2")
        x = rms_norm(x, P["encoder.norm"])
        if e["out_channels"] != e["dim"]:
            x = x @ wn_weight(P, "encoder.output_proj")[..., 0].T + P["encoder.output_proj.b"]
        out.append(x.T)
    return out
