"""The port's spans (``utils/trace.py``): off by default and then a shared
no-op, on under ``recording()`` or while ``torch.profiler`` records,
nesting and call ids, the bounded list, device time from two timing
events, no profiler event named after a span, and the trees a ragged
tokenize of the tiny BigCodec and Conformer leaves, with tokens equal to
an untraced call."""
import collections
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import __graft_entry__ as GE
from audiotokenization_tpu_torch import config as PC
from audiotokenization_tpu_torch.models import codec as TC
from audiotokenization_tpu_torch.utils import trace
from audiotokenization_tpu_torch.utils.ragged import make_ragged_tokenizer

LENGTHS = {"bigcodec": [730, 400, 1000], "conformer": [1200, 800, 2000, 0]}


@pytest.fixture(autouse=True)
def fresh():
    trace.clear()
    yield
    trace.clear()


def test_off_is_one_shared_noop():
    a, b = trace.span("a"), trace.span("b", "cpu")
    assert a is b
    with a as got:
        assert got is None
    assert trace.records() == []


def test_recording_nests_with_parents_and_calls():
    with trace.recording():
        with trace.span("outer") as outer:
            with trace.span("mid", "cpu") as mid:
                with trace.span("inner") as inner:
                    pass
            with trace.span("second") as second:
                pass
        with trace.span("alone") as alone:
            pass
    assert trace.span("after") is trace.span("off")  # off again once the block closes
    assert trace.records() == [outer, mid, inner, second, alone]
    assert [r.parent for r in trace.records()] == [None, outer.id, mid.id, outer.id, None]
    assert {outer.call, mid.call, inner.call, second.call} == {outer.id}
    assert alone.call == alone.id != outer.id
    assert mid.device_s is None  # events only on a CUDA device
    stamps = [outer.start_ns, mid.start_ns, inner.start_ns, inner.end_ns, mid.end_ns,
              second.start_ns, second.end_ns, outer.end_ns, alone.start_ns, alone.end_ns]
    assert stamps == sorted(stamps)


def test_the_list_is_bounded(monkeypatch):
    monkeypatch.setattr(trace, "_RECORDS", collections.deque(maxlen=3))
    with trace.recording():
        for i in range(5):
            with trace.span(f"s{i}"):
                pass
    assert [r.name for r in trace.records()] == ["s2", "s3", "s4"]
    trace.clear()
    assert trace.records() == []


class _FakeEvent:
    """A timing event stamped with its stream's made-up clock (ms)."""

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.at = None

    def record(self, stream):
        self.at = stream.tick()

    def elapsed_time(self, end):
        return end.at - self.at


class _FakeStream:
    def __init__(self):
        self.ms = 0.0

    def tick(self):
        self.ms += 1.5
        return self.ms


def test_device_time_is_the_stream_time_between_two_events(monkeypatch):
    """On a CUDA device, without one: fake events on the current stream,
    recorded at entry and exit; ``device_s`` their elapsed time."""
    stream = _FakeStream()
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: stream)
    with trace.recording():
        with trace.span("a", torch.device("cuda", 0)) as a:      # entry at 1.5 ms
            with trace.span("b", "cuda:0") as b:                 # 3.0 to 4.5
                pass
            with trace.span("c") as c:                           # no device: no events
                pass
    assert [e.at for e in a.events + b.events] == [1.5, 6.0, 3.0, 4.5]
    assert (a.device_s, b.device_s, c.device_s) == (pytest.approx(4.5e-3), pytest.approx(1.5e-3),
                                                    None)


def test_on_while_the_profiler_records_and_absent_from_its_events():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.span("a") is not trace.span("b")  # on: a span of its own
        with trace.span("port.outer", "cpu"):
            with trace.span("port.inner"):
                torch.ones(4).add_(1)
    assert trace.span("a") is trace.span("b")
    assert [r.name for r in trace.records()] == ["port.outer", "port.inner"]
    names = {e.name for e in prof.events()}
    assert "aten::add_" in names and not names & {"port.outer", "port.inner"}


def _tiny(family):
    jcfg = GE._tiny_config() if family == "bigcodec" else GE._tiny_conformer_config()
    jcfg.train.precision = "fp32"
    if family == "conformer":
        jcfg.model.codec_encoder.n_layers = 2
    cfg = PC.from_dict(dataclasses.asdict(jcfg))
    codec = TC.init_codec(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    lengths = LENGTHS[family]
    wavs = torch.zeros(len(lengths), max(lengths))
    gen = torch.Generator().manual_seed(1)
    for i, n in enumerate(lengths):
        wavs[i, :n] = 0.1 * torch.randn(n, generator=gen)
    return cfg, codec, wavs, torch.tensor(lengths)


@pytest.mark.parametrize("family", ["bigcodec", "conformer"])
def test_ragged_tokenize_tree_and_equal_tokens(family):
    cfg, codec, wavs, lengths = _tiny(family)
    run = make_ragged_tokenizer(cfg, device="cpu")
    plain = run(codec, wavs, lengths)
    assert trace.records() == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = run(codec, wavs, lengths)
    assert torch.equal(plain, traced)
    recs = trace.records()
    assert not {e.name for e in prof.events()} & {r.name for r in recs}
    call = recs[0]
    assert call.name == "ragged.call" and call.parent is None
    assert all(r.call == call.id for r in recs)
    assert all(call.start_ns <= r.start_ns <= r.end_ns <= call.end_ns for r in recs[1:])
    if family == "bigcodec":
        (lstm,) = recs[1:]
        assert lstm.name == "lstm.res" and lstm.parent == call.id
        return
    backbone, *layers = recs[1:]
    assert backbone.name == "conformer.backbone" and backbone.parent == call.id
    assert all(r.parent == backbone.id for r in layers)
    # per layer the attention and the two feed-forwards, in the layer's order
    attn, ffn = "transformer.attention", "transformer.ffn"
    one = [ffn, attn, ffn] if codec.encoder.backbone.conv_first else [attn, ffn, ffn]
    assert [r.name for r in layers] == one * 2
