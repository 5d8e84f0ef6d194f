"""The readers of the port's spans (``metrics/_spans.py``) on made-up views
and records: the rooflines (work from the window's batches and the
config, time from the spans) and the backbone's launch gaps worked by
hand, the window's calls and their alignment (None past a median residual
of 200 us, or where a port call leaves its harness call), nothing where
there are no spans or a call holds another number of them, and the layer
counts against the encoder counts whose terms they repeat."""
import json
import sys
from types import SimpleNamespace

import pytest
import torch

from portbench.counts import bigcodec, conformer, layers
from portbench.harness import peaks
from portbench.harness.bench import ROOT, module_from_path
from portbench.harness.trace import union_us
from portbench.metrics import _spans

P0 = 1_760_000_000_000_000_000  # a port stamp (ns) where the trace's clock reads 1,000 us
NAMES = ("lstm_roofline.tokenize", "attention_roofline.tokenize.conformer",
         "ffn_roofline.tokenize.conformer", "launch_idle_share.tokenize.conformer")


def _read(name, view):
    return module_from_path(f"portbench/metrics/{name}.py").read(view)


def _config(name, **encoder):
    cfg = json.loads((ROOT / f"portbench/configs/{name}.json").read_text())
    cfg["model"]["codec_encoder"].update(encoder)
    return cfg


def _view(config, work, calls, events=(), window_us=(0.0, 10_000.0)):
    """A traced window: the harness's ``ragged_call`` spans at ``calls``
    (start, end) us, one a batch of ``work``."""
    host = [("assemble", a - 50.0, a) for a, _ in calls]
    host += [("ragged_call", a, b) for a, b in calls]
    return SimpleNamespace(config=config, work=work, host=host, events=list(events),
                           window_us=window_us, window_s=(window_us[1] - window_us[0]) / 1e6,
                           busy_s=union_us([(a, b) for _, a, b in events]) / 1e6)


class Recs:
    """Made-up port records, each added at its trace times (us)."""

    def __init__(self):
        self.list = []

    def add(self, name, start_us, end_us, parent=None, device_s=None):
        rid = len(self.list) + 1
        call = rid if parent is None else self.list[parent - 1].call
        ns = [P0 + int((t - 1000.0) * 1e3) for t in (start_us, end_us)]
        self.list.append(SimpleNamespace(id=rid, name=name, parent=parent, call=call,
                                         device_s=device_s, start_ns=ns[0], end_ns=ns[1]))
        return rid


@pytest.fixture
def recs(monkeypatch):
    r = Recs()
    monkeypatch.setattr(_spans, "port_records", lambda: list(r.list))
    return r


def test_lstm_roofline_by_hand(recs):
    cfg = _config("bigcodec")
    # an earlier window's call: not the window's, so not read
    old = recs.add("ragged.call", -9000, -8000)
    recs.add("lstm.res", -8900, -8100, old, device_s=5.0)
    call = recs.add("ragged.call", 1000, 9000)
    recs.add("lstm.res", 6000, 8000, call, device_s=0.002)
    # 3 rows: 160 and 80 frames, and a padding row that runs one
    view = _view(cfg, [(3, 32000, [32000, 16000])], [(1000, 9000)])
    h, frames = 1536, 160 + 80 + 1
    ops = frames * (2 * (2 * 4 * h * 2 * h + 17 * h) + h)
    nbytes = 4 * (2 * 2 * frames * h + 2 * (4 * h * 2 * h + 8 * h))
    want = 100 * max(ops / peaks.TF32_FLOPS, nbytes / peaks.HBM_BYTES) / 0.002
    assert _read("lstm_roofline.tokenize", view) == pytest.approx(want)
    for name in NAMES[1:]:
        assert _read(name, view) is None  # no Conformer spans


def _conformer_call(recs, a, b, ffn_s=2e-3, attn_s=1e-3):
    """One call of a one-layer Conformer: ffn, attention, ffn inside the
    backbone."""
    call = recs.add("ragged.call", a, b)
    bb = recs.add("conformer.backbone", a + 1000, b - 1000, call)
    recs.add("transformer.ffn", a + 1000, a + 2000, bb, device_s=ffn_s)
    recs.add("transformer.attention", a + 2000, a + 4000, bb, device_s=attn_s)
    recs.add("transformer.ffn", a + 5000, a + 6000, bb, device_s=ffn_s)
    return call


def test_attention_and_ffn_rooflines_by_hand(recs):
    cfg = _config("conformer", n_layers=1)
    _conformer_call(recs, 1000, 9000)
    view = _view(cfg, [(2, 16000, [16000, 8000])], [(1000, 9000)])
    c, f, m = 256, 80, 2 * 80  # padded frames, as every row runs them
    attn = m * (4 * c + 6 * c * c + 8 * c + 6 * c + 4 * f * c + 3 * f * 8 + 2 * c * c + c)
    least = max(attn / peaks.TF32_FLOPS, 4 * (4 * m * c + 4 * c * c) / peaks.HBM_BYTES)
    assert _read(NAMES[1], view) == pytest.approx(100 * least / 1e-3)
    ffn = m * (4 * c + 6 * c * 768 + 3 * 768 + c)
    least = max(ffn / peaks.TF32_FLOPS, 4 * (2 * m * c + 3 * c * 768) / peaks.HBM_BYTES)
    assert _read(NAMES[2], view) == pytest.approx(100 * 2 * least / 4e-3)
    assert _read(NAMES[0], view) is None


def test_a_call_with_another_number_of_spans_reads_none(recs):
    """The config's six layers, the spans of one: the work counted would not
    be the work timed."""
    _conformer_call(recs, 1000, 9000)
    view = _view(_config("conformer"), [(2, 16000, [16000, 8000])], [(1000, 9000)])
    assert _read(NAMES[1], view) is None and _read(NAMES[2], view) is None
    view.config["model"]["codec_encoder"]["n_layers"] = 1
    assert _read(NAMES[1], view) is not None and _read(NAMES[2], view) is not None


def test_launch_idle_share_by_hand(recs):
    cfg = _config("conformer")
    call = recs.add("ragged.call", 1000, 9000)
    bb = recs.add("conformer.backbone", 2000, 6000, call)
    recs.add("transformer.attention", 2500, 3600, bb)
    events = [("k", 0, 2000), ("k", 2600, 3000), ("k", 4000, 5000), ("k", 6600, 6800),
              ("k", 8000, 10_000)]
    view = _view(cfg, [(2, 16000, [16000, 8000])], [(1000, 9000)], events)
    # gaps 2000-2600 (in the backbone), 3000-4000 (in its attention), 5000-6600
    # (in the backbone), 6800-8000 (in the call only): 3,200 us of 10,000
    assert _read(NAMES[3], view) == pytest.approx(32.0)
    # the offset is found, not assumed: the same spans 7 ms later on the port's clock
    for r in recs.list:
        r.start_ns += 7_000_000
        r.end_ns += 7_000_000
    assert _read(NAMES[3], view) == pytest.approx(32.0)


@pytest.mark.parametrize("late_us,aligns", [((0, 150, 190), True), ((0, 1500, 0), True),
                                            ((0, 250, 210), False)])
def test_alignment_and_its_residual(recs, late_us, aligns):
    """Residuals from the earliest call: a lone stall (1.5 ms) leaves the
    median at 0, most calls late by more than 200 us do not align."""
    cfg = _config("conformer")
    work = [(2, 16000, [16000, 8000]), (2, 32000, [32000, 16000]), (1, 16000, [16000])]
    calls = [(1000, 4000), (5000, 9000), (9500, 9900)]
    for (a, b), late in zip(calls, late_us):
        call = recs.add("ragged.call", a, b - 300)
        recs.list[-1].start_ns += int(late * 1e3)
        recs.add("conformer.backbone", a + 500, b - 500, call)
    view = _view(cfg, work, calls, [("k", 0, 500)])
    pairs, to_us, residuals = _spans.window_calls(view, _spans.port_records())
    assert [w for _, _, w in pairs] == work
    assert residuals == pytest.approx(list(late_us))
    assert to_us(recs.list[0].start_ns) == pytest.approx(1000.0)
    assert (_read(NAMES[3], view) is not None) is aligns


def test_a_port_call_past_its_harness_call_does_not_pair(recs):
    cfg = _config("conformer", n_layers=1)
    _conformer_call(recs, 1000, 9200)
    view = _view(cfg, [(2, 16000, [16000, 8000])], [(1000, 9000)], [("k", 0, 500)])
    assert _spans.window_calls(view, _spans.port_records()) is None
    assert all(_read(n, view) is None for n in NAMES)


def test_none_without_spans_or_pairs(recs, monkeypatch):
    work = [(2, 16000, [16000, 8000]), (2, 8000, [8000, 8000])]
    calls = [(1000, 9000), (9100, 9900)]
    for cfg in ("bigcodec", "conformer"):
        view = _view(_config(cfg, n_layers=1), work, calls, [("k", 0, 500)])
        assert all(_read(n, view) is None for n in NAMES)  # no records at all
    _conformer_call(recs, 1000, 9000)
    view = _view(_config("conformer", n_layers=1), work, calls, [("k", 0, 500)])
    assert _spans.window_calls(view, _spans.port_records()) is None  # one port call for two
    assert all(_read(n, view) is None for n in NAMES)
    view = _view(_config("conformer", n_layers=1), work[:1], calls[:1], [("k", 0, 500)])
    assert _read(NAMES[2], view) is not None and _read(NAMES[3], view) is not None
    monkeypatch.setattr(recs.list[2], "device_s", None)  # no device events: no device time
    assert _read(NAMES[2], view) is None


def test_a_program_without_spans_reads_none(monkeypatch):
    monkeypatch.setitem(sys.modules, "audiotokenization_tpu_torch.utils.trace", None)
    assert _spans.port_records() == []


@pytest.mark.parametrize("family", ["bigcodec", "conformer"])
def test_the_port_records_what_the_readers_read(family, tiny_bigcodec, tiny_conformer):
    """The tiny codecs' ragged calls under ``trace.recording()``: the calls
    pair with the harness's spans, each holds the spans a reader counts
    for it, and with device times given (the CPU records none) the
    family's readers read."""
    from audiotokenization_tpu_torch.config import from_dict
    from audiotokenization_tpu_torch.models.codec import init_codec
    from audiotokenization_tpu_torch.utils import trace
    from audiotokenization_tpu_torch.utils.ragged import make_ragged_tokenizer

    config = tiny_bigcodec if family == "bigcodec" else tiny_conformer
    cfg = from_dict({k: config[k] for k in ("model", "train", "dataset")})
    codec = init_codec(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    run = make_ragged_tokenizer(cfg, device="cpu")
    work = [(2, 400, [400, 300]), (2, 200, [200])]
    trace.clear()
    with trace.recording():
        for rows, samples, lengths in work:
            padded = lengths + [0] * (rows - len(lengths))
            run(codec, torch.zeros(rows, samples), torch.tensor(padded))
    records = trace.records()
    trace.clear()
    assert all(r.device_s is None for r in records)  # no events on the CPU
    calls = [r for r in records if r.name == "ragged.call"]
    t0 = calls[0].start_ns
    harness = [((r.start_ns - t0) / 1e3 + 100.0, (r.end_ns - t0) / 1e3 + 100.0) for r in calls]
    view = _view(config, work, harness, [("k", 0.0, 50.0)],
                 window_us=(0.0, harness[-1][1] + 100.0))
    pairs, _, residuals = _spans.window_calls(view, records)
    assert [r for r, _, _ in pairs] == calls and residuals == [0.0, 0.0]
    timed = [SimpleNamespace(**{k: getattr(r, k) for k in ("id", "name", "parent", "call",
                                                           "start_ns", "end_ns")},
                             device_s=1e-3) for r in records]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_spans, "port_records", lambda: timed)
        got = {n: _read(n, view) for n in NAMES}
    reads = NAMES[:1] if family == "bigcodec" else NAMES[1:]
    assert all((got[n] is not None) is (n in reads) for n in NAMES), got


def test_layer_counts_are_the_encoder_counts_terms():
    e = _config("bigcodec")["model"]["codec_encoder"]
    hop, h, n = 16000 // 80, 1536, 16000 * 3
    without = bigcodec.encoder_ops({**e, "use_rnn": False}, n)
    assert bigcodec.encoder_ops(e, n) - without == layers.lstm_ops(h, 2, n // hop)
    assert layers.lstm_bytes(h, 1, 10) == 4 * (2 * 10 * h + 4 * h * 2 * h + 2 * 4 * h)
    # a batch of 3 rows: 240 and 80 frames, one padding row of one step
    frames = 240 + 80 + 1
    assert layers.lstm_work(e, 3, n, [n, 16000]) == (layers.lstm_ops(h, 2, frames),
                                                     layers.lstm_bytes(h, 2, frames))

    e = _config("conformer")["model"]["codec_encoder"]
    c, hid, k = e["dim"], conformer.swiglu_hidden(e["dim"], e["ffn_mult"]), e["conv_kernel_size"]
    conv = 4 * c + 4 * c * c + 4 * c + 2 * k * c + c + 4 * c + 2 * c + 2 * c * c + 2 * c
    for seconds in (1, 7):
        f = seconds * 16000 // e["hop_length"]
        one = conformer.encoder_ops({**e, "n_layers": 1}, seconds * 16000)
        none = conformer.encoder_ops({**e, "n_layers": 0}, seconds * 16000)
        layer = layers.attention_ops(c, e["n_head"], f) + 2 * layers.ffn_ops(c, hid) + conv
        assert one - none == f * layer
        # a batch's layer at its padded frames, whatever its rows' own lengths
        batch = (3, seconds * 16000, [16000])
        assert layers.attention_work(e, *batch) == (3 * f * layers.attention_ops(c, e["n_head"], f),
                                                    layers.attention_bytes(3, f, c))
        assert layers.ffn_work(e, *batch) == (3 * f * layers.ffn_ops(c, hid),
                                              layers.ffn_bytes(3, f, c, hid))
