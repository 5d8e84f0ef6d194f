"""The operation and byte counters against hand counts."""
import json

from portbench.counts import bigcodec, conformer, vq
from portbench.harness.bench import ROOT


def _cfg(name):
    return json.loads((ROOT / f"portbench/configs/{name}.json").read_text())["model"]


def test_one_residual_unit_by_hand():
    c, t = 48, 1000
    k7, k1 = 2 * 7 * c * c * t, 2 * c * c * t      # multiply-adds of the two products
    biases, snakes, residual = 2 * c * t, 2 * 5 * c * t, c * t
    assert bigcodec.unit_ops(c, t) == k7 + k1 + biases + snakes + residual
    assert bigcodec.unit_bytes(c, t, rows=2) == 4 * (2 * 2 * c * t + 7 * c * c + c * c + 2 * c
                                                     + 4 * c)


def test_k1_by_hand():
    assert vq.k1_ops(2560, 8192, 8) == 2560 * 8192 * 19
    assert vq.k1_bytes(10, 4, 8) == 4 * (80 + 32 + 10)


def test_flagship_encoder_per_audio_second():
    e = _cfg("bigcodec")["codec_encoder"]
    ops = bigcodec.encoder_ops(e, 16000)
    units = sum(bigcodec.unit_ops(c, t) for c, t in bigcodec.encoder_units(e, 16000))
    assert 50e9 < ops < 52e9            # about 51 GFLOP an audio-second
    assert 37.5e9 < units < 38.5e9      # of which the units are 38


def test_units_of_one_tokenize_and_decode_at_32x1s():
    """PERF.md's K2 bound: 14.69 ms at 165 TFLOP/s is ~2.42 TFLOP."""
    m = _cfg("bigcodec")
    enc = sum(bigcodec.unit_ops(c, t) for c, t in bigcodec.encoder_units(m["codec_encoder"],
                                                                        16000))
    d = m["codec_decoder"]
    ch, t, dec = d["upsample_initial_channel"], 80, 0
    for i, s in enumerate(d["up_ratios"]):
        t *= s
        dec += len(d["dilations"]) * bigcodec.unit_ops(ch // 2 ** (i + 1), t)
    total = 32 * (enc + dec)
    assert abs(total - 14.69e-3 * 165e12) / total < 0.01


def test_conformer_encoder():
    e = _cfg("conformer")["codec_encoder"]
    one = conformer.encoder_ops(e, 16000)
    assert 1.5e9 < one < 1.9e9  # about 1.7 GFLOP at 1 s: 6 layers of 256 at 80 frames
    f, c = 80, 256
    per_layer_products = 2 * c * (2 * c + c + 3 * c + c) + 2 * 2 * 3 * c * 768 + 2 * 2 * f * c
    assert one > e["n_layers"] * f * per_layer_products
    # attention grows with the square of the frames
    assert conformer.encoder_ops(e, 2 * 16000 * 10) > 2 * conformer.encoder_ops(e, 16000 * 10)
