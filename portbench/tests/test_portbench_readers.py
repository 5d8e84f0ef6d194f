"""The per-layer readers on a made-up trace: their arithmetic, and nothing
where there is nothing to read."""
import json
from types import SimpleNamespace

import pytest

from portbench.counts import bigcodec, vq
from portbench.harness import peaks
from portbench.harness.bench import ROOT, module_from_path
from portbench.harness.trace import TraceView, union_us


def _reader(name):
    return module_from_path(f"portbench/metrics/{name}.py")


def _view(config, events, work, window_s=2.0):
    v = SimpleNamespace(config=config, events=events, work=work, window_s=window_s,
                        busy_s=union_us([(a, b) for _, a, b in events]) / 1e6)
    v.kernel_s = lambda match: TraceView.kernel_s(v, match)
    return v


def _config(name):
    return json.loads((ROOT / f"portbench/configs/{name}.json").read_text())


def test_union_of_overlapping_spans():
    assert union_us([(0, 10), (5, 20), (30, 40)]) == 30


def test_idle_share():
    v = _view(_config("bigcodec"), [("k", 0.0, 0.5e6), ("k", 1.0e6, 1.5e6)], [(1, 16000, [16000])])
    assert _reader("idle_share.tokenize").read(v) == pytest.approx(50.0)
    assert _reader("idle_share.tokenize").read(_view(_config("bigcodec"), [], [])) is None


def test_k2_roofline_by_hand():
    cfg = _config("bigcodec")
    e = cfg["model"]["codec_encoder"]
    work = [(32, 32000, [32000] * 32)]
    least = sum(peaks.least_seconds(32 * bigcodec.unit_ops(c, t), bigcodec.unit_bytes(c, t, 32))
                for c, t in bigcodec.encoder_units(e, 32000))
    v = _view(cfg, [("void tf32unit::unit_gemm<x>", 0.0, 0.4e6), ("other", 0.4e6, 0.9e6)], work)
    assert _reader("k2_roofline.tokenize").read(v) == pytest.approx(100 * least / 0.4)
    assert _reader("k2_roofline.tokenize").read(_view(_config("conformer"), v.events, work)) is None
    assert _reader("k2_roofline.tokenize").read(_view(cfg, [("other", 0, 1)], work)) is None


def test_k1_roofline_and_mfu_by_hand():
    cfg = _config("conformer")
    d, e = cfg["model"]["codec_decoder"], cfg["model"]["codec_encoder"]
    work = [(32, 16000, [16000, 8000])]
    m = 32 * 80
    v = _view(cfg, [("vq_argmin_cluster<8>", 0.0, 1e3)], work)
    want = 100 * peaks.least_seconds(vq.k1_ops(m, 8192, 8), vq.k1_bytes(m, 8192, 8)) / 1e-3
    assert _reader("k1_roofline.tokenize").read(v) == pytest.approx(want)
    from portbench.counts import conformer
    ops = sum(conformer.encoder_ops(e, n) + vq.vq_ops(d, n // 200) for n in (16000, 8000))
    assert _reader("mfu.tokenize").read(v) == pytest.approx(100 * ops / (2.0 * peaks.TF32_FLOPS))


def test_every_metric_file_reads():
    """Each per-layer metric of BENCHMARK.json has its reader; the Conformer
    cell's read as the BigCodec cell's do."""
    from portbench.harness.bench import load_json
    from portbench.metrics import _tokenize

    for m in load_json(ROOT / "BENCHMARK.json")["per_layer"]:
        read = _reader(m["name"]).read
        assert read is getattr(_tokenize, m["name"].split(".")[0])
