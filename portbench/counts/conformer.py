"""Counts of the Conformer STFT encoder (``reference/conformer.py``'s algorithm)."""
from __future__ import annotations

import math

NORM = 4  # square, mean, rsqrt, scale (per element)


def swiglu_hidden(dim: int, mult: int) -> int:
    return 256 * -(-int(2 * dim * mult / 3) // 256)


def encoder_ops(e: dict, samples: int) -> int:
    """The whole encoder for one utterance of ``samples``: the windowed real
    FFT of each frame (2.5 n log2 n), input_proj, the layers (attention over
    the utterance's own frames) and the norms."""
    n, c, h = e["n_fft"], e["dim"], e["n_head"]
    f = samples // e["hop_length"]
    nf = 2 * (n // 2 + 1)
    hid = swiglu_hidden(c, e["ffn_mult"])
    ops = f * (n + int(2.5 * n * math.log2(n)))
    ops += f * (2 * nf * c + c + NORM * c)
    conv = NORM * c + 2 * c * 2 * c + 2 * c + 2 * c + 2 * e["conv_kernel_size"] * c + c \
        + NORM * c + 2 * c + 2 * c * c + c + c
    ffn = NORM * c + 3 * 2 * c * hid + 3 * hid + c
    attn = NORM * c + 2 * c * 3 * c + 2 * NORM * c + 6 * c + 2 * f * c + 3 * f * h \
        + 2 * f * c + 2 * c * c + c
    ops += e["n_layers"] * f * (conv + 2 * ffn + attn)
    ops += f * NORM * c
    if e["out_channels"] != c:
        ops += f * (2 * c * e["out_channels"] + e["out_channels"])
    return ops
