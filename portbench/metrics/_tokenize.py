"""The tokenize readers' arithmetic, shared by the cells' metric files."""
from __future__ import annotations

from portbench.counts import bigcodec, conformer, vq
from portbench.harness import peaks

ENCODERS = {"bigcodec": bigcodec.encoder_ops, "conformer_stft": conformer.encoder_ops}
K1, K2 = "vq_argmin", "unit_gemm"  # the port's kernel names, as the device trace has them


def hop(config: dict) -> int:
    e = config["model"]["codec_encoder"]
    if e["type"] == "bigcodec":
        out = 1
        for s in e["up_ratios"]:
            out *= s
        return out
    return e["hop_length"]


def idle_share(view):
    """Share of the traced window in which the device ran nothing (%)."""
    if view.window_s <= 0 or not view.events:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)


def mfu(view):
    """The tokenize work of the window's utterances (encoder and the
    quantizer's search, counted from their own lengths: no padding, no
    recompute) over the window and the chip's dense TF32 peak (%): no
    fp32-grade route on the chip is faster than that peak."""
    if not view.work or view.window_s <= 0:
        return None
    e, d = view.config["model"]["codec_encoder"], view.config["model"]["codec_decoder"]
    count, h = ENCODERS[e["type"]], hop(view.config)
    ops = sum(count(e, n) + vq.vq_ops(d, n // h) for _, _, lengths in view.work for n in lengths)
    return 100.0 * ops / (view.window_s * peaks.TF32_FLOPS)


def k2_roofline(view):
    """K2's share of its roofline (%): the least time of the encoder's
    residual units at the shapes the batches ran (rows x padded length;
    snake, dilated k7 product, k1 product, biases, residual; fp32 inputs
    and outputs once, weights once a call) at the chip's peaks, over the
    device time of the kernels that computed them."""
    e = view.config["model"]["codec_encoder"]
    spent = view.kernel_s(K2)
    if e["type"] != "bigcodec" or spent <= 0 or not view.work:
        return None
    least = sum(peaks.least_seconds(rows * bigcodec.unit_ops(c, t),
                                    bigcodec.unit_bytes(c, t, rows))
                for rows, padded, _ in view.work for c, t in bigcodec.encoder_units(e, padded))
    return 100.0 * least / spent


def k1_roofline(view):
    """K1's share of its roofline (%): m x n x (2d + 3) operations and the
    rows', codebook's and indices' bytes of every call (m: the batch's rows
    x padded frames) at the chip's peaks, over the kernel's device time."""
    d = view.config["model"]["codec_decoder"]
    spent = view.kernel_s(K1)
    if spent <= 0 or not view.work:
        return None
    h, n, dim = hop(view.config), d["codebook_size"], d["codebook_dim"]
    least = sum(peaks.least_seconds(vq.k1_ops(rows * (padded // h), n, dim),
                                    vq.k1_bytes(rows * (padded // h), n, dim))
                for rows, padded, _ in view.work)
    return 100.0 * least / spent
