"""Plain reference of the BigCodec encoder (Xin et al. 2024), each utterance
as it computes alone, fp32: WNConv1d(1 -> ngf, k7) -> per stride an EncoderBlock (three
residual units x + WNConv_k1(snake(WNConv_k7,dil(snake(x)))), snake, strided
WNConv) -> a 2-layer ResLSTM (x + LSTM(x)) -> snake -> WNConv1d(k3).

Parameter names follow the program's state dict; the decoder's are listed
so that the program's codec can be filled whole. Imports torch only.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import Spec, snake_beta, vq_specs, wn_specs, wn_weight


def _snake_specs(name, c):
    return [Spec(f"{name}.alpha", (c,), "snake"), Spec(f"{name}.beta", (c,), "snake")]


def _unit_specs(pre, c):
    return (_snake_specs(f"{pre}.snake1", c) + wn_specs(f"{pre}.conv1", (c, c, 7))
            + _snake_specs(f"{pre}.snake2", c) + wn_specs(f"{pre}.conv2", (c, c, 1)))


def _lstm_specs(pre, size, layers):
    out = []
    for l in range(layers):
        init = f"fan_in:{size}"
        out += [Spec(f"{pre}.weight_ih_l{l}", (4 * size, size), init),
                Spec(f"{pre}.weight_hh_l{l}", (4 * size, size), init),
                Spec(f"{pre}.bias_ih_l{l}", (4 * size,), init),
                Spec(f"{pre}.bias_hh_l{l}", (4 * size,), init)]
    return out


def param_specs(cfg):
    """Every tensor of the codec: (name, shape, init)."""
    e, d = cfg["model"]["codec_encoder"], cfg["model"]["codec_decoder"]
    ndil = len(e["dilations"])
    out = wn_specs("encoder.conv_in", (e["ngf"], 1, 7))
    c = e["ngf"]
    for i, s in enumerate(e["up_ratios"]):
        pre = f"encoder.blocks.{i}"
        for j in range(ndil):
            out += _unit_specs(f"{pre}.units.{j}", c)
        out += _snake_specs(f"{pre}.snake", c)
        out += wn_specs(f"{pre}.down", (2 * c, c, 2 * s if s != 1 else 1))
        c *= 2
    out += _lstm_specs("encoder.lstm", c, e["rnn_num_layers"])
    out += _snake_specs("encoder.snake_out", c)
    out += wn_specs("encoder.conv_out", (e["out_channels"], c, 3))
    ch = d["upsample_initial_channel"]
    out += wn_specs("decoder.conv_in", (ch, d["in_channels"], 7))
    out += _lstm_specs("decoder.lstm", ch, d["rnn_num_layers"])
    for i, s in enumerate(d["up_ratios"]):
        pre = f"decoder.blocks.{i}"
        cin, cout = ch // 2 ** i, ch // 2 ** (i + 1)
        out += _snake_specs(f"{pre}.snake", cin)
        out += wn_specs(f"{pre}.up", (cin, cout, 2 * s if s != 1 else 1), transpose=True)
        for j in range(len(d["dilations"])):
            out += _unit_specs(f"{pre}.units.{j}", cout)
    cout = ch // 2 ** len(d["up_ratios"])
    out += _snake_specs("decoder.snake_out", cout)
    out += wn_specs("decoder.conv_out", (1, cout, 7))
    return out + vq_specs(cfg)


def _wn_conv(x, P, name, **kw):
    return F.conv1d(x, wn_weight(P, name), P[f"{name}.b"], **kw)


def _lstm(xs, P, pre, layers):
    """A one-way LSTM from a zero state over each of ``xs`` (T_i, C), gates
    [i, f, g, o]. The sequences run side by side, zero-padded at their ends:
    a step's output depends on the steps before it only, so each sequence's
    own steps are what it gives alone."""
    lengths = [x.shape[0] for x in xs]
    x = torch.nn.utils.rnn.pad_sequence(list(xs), batch_first=True)  # (B, T, C)
    for l in range(layers):
        w_ih, w_hh = P[f"{pre}.weight_ih_l{l}"], P[f"{pre}.weight_hh_l{l}"]
        xg = x @ w_ih.T + (P[f"{pre}.bias_ih_l{l}"] + P[f"{pre}.bias_hh_l{l}"])
        H = w_hh.shape[1]
        h = x.new_zeros(x.shape[0], H)
        c = x.new_zeros(x.shape[0], H)
        out = []
        for t in range(x.shape[1]):
            i, f, g, o = (xg[:, t] + h @ w_hh.T).split(H, dim=1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            out.append(h)
        x = torch.stack(out, dim=1)
    return [x[b, :n] for b, n in enumerate(lengths)]


def _front(P, e, wav):
    x = _wn_conv(wav[None, None, :], P, "encoder.conv_in", padding=3)
    for i, s in enumerate(e["up_ratios"]):
        pre = f"encoder.blocks.{i}"
        for j, dil in enumerate(e["dilations"]):
            u = f"{pre}.units.{j}"
            y = _wn_conv(snake_beta(x, P, f"{u}.snake1"), P, f"{u}.conv1",
                         padding=3 * dil, dilation=dil)
            x = x + _wn_conv(snake_beta(y, P, f"{u}.snake2"), P, f"{u}.conv2")
        x = snake_beta(x, P, f"{pre}.snake")
        if s != 1:
            x = _wn_conv(x, P, f"{pre}.down", stride=s, padding=s // 2 + s % 2)
        else:
            x = _wn_conv(x, P, f"{pre}.down")
    return x[0]


def encode(P, cfg, wavs):
    """wavs: a list of (T,) fp32 utterances, each T a multiple of the hop ->
    a list of latents (out_channels, T / hop), each utterance computed alone."""
    e = cfg["model"]["codec_encoder"]
    xs = [_front(P, e, w) for w in wavs]
    if e["use_rnn"]:
        ys = _lstm([x.T for x in xs], P, "encoder.lstm", e["rnn_num_layers"])
        xs = [x + y.T for x, y in zip(xs, ys)]
    out = []
    for x in xs:
        x = snake_beta(x[None], P, "encoder.snake_out")
        out.append(_wn_conv(x, P, "encoder.conv_out", padding=1)[0])
    return out
