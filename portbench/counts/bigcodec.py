"""Counts of the BigCodec encoder (``reference/bigcodec.py``'s algorithm)."""
from __future__ import annotations

import math

SNAKE = 5  # a*x, sin, square, times 1/b, plus x


def unit_ops(c: int, t: int) -> int:
    """One residual unit over (c, t): the k7 and k1 products with their
    biases, two snakes and the residual add."""
    return t * (16 * c * c + 13 * c)


def unit_bytes(c: int, t: int, rows: int = 1) -> int:
    """fp32: the input read and the output written once per row, the two
    weights, two biases and four snake vectors once."""
    return 4 * (2 * c * t * rows + 8 * c * c + 6 * c)


def encoder_units(e: dict, samples: int):
    """(channels, positions) of each residual unit of the encoder for one
    row of ``samples``."""
    c, t = e["ngf"], samples
    for s in e["up_ratios"]:
        for _ in e["dilations"]:
            yield c, t
        c, t = 2 * c, t // s


def encoder_ops(e: dict, samples: int) -> int:
    """The whole encoder for one row of ``samples``: conv_in, the units, each
    block's snake and strided conv, the ResLSTM, snake_out and conv_out."""
    ops = samples * (2 * 7 * e["ngf"] + e["ngf"])
    ops += sum(unit_ops(c, t) for c, t in encoder_units(e, samples))
    c, t = e["ngf"], samples
    for s in e["up_ratios"]:
        k = 2 * s if s != 1 else 1
        ops += SNAKE * c * t
        t //= s
        ops += t * (2 * k * c * 2 * c + 2 * c)
        c *= 2
    frames = samples // math.prod(e["up_ratios"])
    if e["use_rnn"]:
        # per layer and frame: both products (4H x 2H), two biases, the gates'
        # nonlinearities and products (9H), the skip once
        ops += e["rnn_num_layers"] * frames * (16 * c * c + 8 * c + 9 * c) + frames * c
    ops += SNAKE * c * frames + frames * (2 * 3 * c * e["out_channels"] + e["out_channels"])
    return ops
