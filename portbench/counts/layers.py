"""Counts of single layers, at the shapes a batch of the window ran: the
terms of ``bigcodec.encoder_ops`` and ``conformer.encoder_ops`` that the
layer computes, and the bytes its least implementation moves (fp32).
Each ``*_work`` takes the encoder's config group and a batch's rows,
padded samples and real rows' samples (``view.work``'s entry) and gives
the layer's (operations, bytes) in one call of that batch."""
from __future__ import annotations

import math

from .conformer import NORM, swiglu_hidden


def lstm_ops(hidden: int, layers: int, frames: int) -> int:
    """The one-way ResLSTM over ``frames`` frames (all rows): per layer and
    frame both products 2·4H·(in + H) (in = H), the biases and gates 17H;
    the skip H once a frame."""
    h = hidden
    return frames * (layers * (8 * h * (h + h) + 17 * h) + h)


def lstm_bytes(hidden: int, layers: int, frames: int) -> int:
    """Each layer's input and output once, and every layer's weights and two
    biases once a call: a persistent recurrence with its weights on chip."""
    h = hidden
    return 4 * layers * (2 * frames * h + 4 * h * (h + h) + 2 * 4 * h)


def lstm_work(e: dict, rows: int, padded: int, lengths: list):
    """The BigCodec's ResLSTM in one call: hidden = the last block's width,
    each real row's frames (samples // hop, not the padded frames: the
    recurrence is packed), and one frame for a row of no frames and for
    each padding row past ``lengths`` (a packed sequence runs at least one
    step)."""
    hop, h = math.prod(e["up_ratios"]), e["ngf"] * 2 ** len(e["up_ratios"])
    n = e["rnn_num_layers"]
    frames = sum(max(s // hop, 1) for s in lengths) + rows - len(lengths)
    return lstm_ops(h, n, frames), lstm_bytes(h, n, frames)


def attention_ops(width: int, heads: int, frames: int) -> int:
    """One frame's attention sub-layer over ``frames`` keys: the norm, the
    qkv product, q and k normed and rotated, scores, softmax, the value sum,
    the out product and the residual add."""
    c, f = width, frames
    return (NORM * c + 2 * c * 3 * c + 2 * NORM * c + 6 * c + 2 * f * c + 3 * f * heads
            + 2 * f * c + 2 * c * c + c)


def attention_bytes(rows: int, frames: int, width: int) -> int:
    """q, k, v and the output once, and the four (C, C) weights: a fused
    attention's bound."""
    return 4 * (4 * rows * frames * width + 4 * width * width)


def attention_work(e: dict, rows: int, padded: int, lengths: list):
    """One Conformer layer's attention in one call, at the padded frames
    (padded // hop) every row runs."""
    f, c = padded // e["hop_length"], e["dim"]
    return rows * f * attention_ops(c, e["n_head"], f), attention_bytes(rows, f, c)


def ffn_ops(width: int, hidden: int) -> int:
    """One frame's SwiGLU sub-layer: the norm, three products, SiLU and the
    gate's product, the residual add."""
    c = width
    return NORM * c + 3 * 2 * c * hidden + 3 * hidden + c


def ffn_bytes(rows: int, frames: int, width: int, hidden: int) -> int:
    """The input and the output once, and the three weights."""
    return 4 * (2 * rows * frames * width + 3 * width * hidden)


def ffn_work(e: dict, rows: int, padded: int, lengths: list):
    """One dense SwiGLU feed-forward of a Conformer layer in one call, at the
    padded frames."""
    f, c = padded // e["hop_length"], e["dim"]
    hid = swiglu_hidden(c, e["ffn_mult"])
    return rows * f * ffn_ops(c, hid), ffn_bytes(rows, f, c, hid)
