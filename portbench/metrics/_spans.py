"""The readers of the port's own spans (``audiotokenization_tpu_torch/
utils/trace.py``), which record while the profiler does: their records are
read from the port's memory after the traced window, never from the
profiler's events, and a program without them reads None. Of a span only
its host stamps and its device time are read: each layer's work is
counted here, from the window's batches (``view.work``) and the
configuration, as ``_tokenize.k2_roofline`` counts K2's.

The window's calls: the harness's ``ragged_call`` spans in ``view.host``,
one a batch of ``view.work``, each enclosing one port ``ragged.call``.
The port's spans record only under the profiler, which runs over the
window, so the window's port calls are the last as many the port
recorded, paired in order; the spans of those calls are the window's.

Alignment: the port stamps on the profiler's host clock (CLOCK_REALTIME)
with its own origin, so one constant offset maps a span onto the trace,
the least (port start - harness start) over the window's calls. A call's
residual is its own difference less that least. The calls pair only
where every port call, once mapped, ends inside its harness call. The
host may stall between the harness's stamp and the port's (a call then
reads late, and is still where it was), so the launch share, which needs
the spans placed to within a gap, reads None where the median residual
passes ``MAX_RESIDUAL_US``, not the widest.
"""
from __future__ import annotations

import statistics
from types import SimpleNamespace

from portbench.counts import layers
from portbench.harness import peaks
from portbench.harness.trace import TraceView
from portbench.metrics import _tokenize

MAX_RESIDUAL_US = 200.0
CALL, BACKBONE = "ragged.call", "conformer.backbone"


def port_records() -> list:
    """The port's span records, or none where the program has no spans."""
    try:
        from audiotokenization_tpu_torch.utils import trace
    except ImportError:
        return []
    return trace.records()


def window_calls(view, records):
    """The window's calls: ([(port ``ragged.call``, harness ``ragged_call``
    span, its ``view.work`` batch)] in order, a function from a port stamp
    in ns to the trace's us, each call's residual in us), or None where
    they do not pair (module docstring)."""
    harness = sorted((h for h in view.host if h[0] == "ragged_call"), key=lambda h: h[1])
    calls = [r for r in records if r.name == CALL][-len(harness):] if harness else []
    if not harness or len(harness) != len(view.work) or len(calls) != len(harness):
        return None
    base = calls[0].start_ns
    diffs = [(r.start_ns - base) / 1e3 - h[1] for r, h in zip(calls, harness)]
    offset = min(diffs)

    def to_us(ns):
        return (ns - base) / 1e3 - offset

    if any(to_us(r.end_ns) > h[2] for r, h in zip(calls, harness)):
        return None
    return list(zip(calls, harness, view.work)), to_us, [d - offset for d in diffs]


def _roofline(view, name, per_call, work):
    """The least time of the window's ``name`` spans, ``per_call(encoder
    group)`` of them a call, each ``work(encoder group, *batch)`` ->
    (operations, bytes) at the chip's peaks, over their device time (%);
    None where a call holds another number of them."""
    e = view.config["model"]["codec_encoder"]
    n, records = per_call(e), port_records()
    got = window_calls(view, records)
    if not n or got is None:
        return None
    spent = {r.id: [] for r, _, _ in got[0]}
    for r in records:
        if r.name == name and r.call in spent:
            spent[r.call].append(r.device_s)
    seconds = [s for xs in spent.values() for s in xs]
    if any(len(xs) != n for xs in spent.values()) or None in seconds or sum(seconds) <= 0:
        return None
    least = n * sum(peaks.least_seconds(*work(e, *batch)) for _, _, batch in got[0])
    return 100.0 * least / sum(seconds)


def lstm_roofline(view):
    """The ResLSTM's share of its roofline (%): its operations at the
    frames each row runs and a persistent recurrence's bytes, over the
    ``lstm.res`` spans' device time."""
    return _roofline(view, "lstm.res",
                     lambda e: int(e["type"] == "bigcodec" and e["use_rnn"]), layers.lstm_work)


def attention_roofline(view):
    """The attention sub-layers' share of their roofline (%): their
    operations at the padded frames and a fused attention's bytes, over
    the ``transformer.attention`` spans' device time."""
    return _roofline(view, "transformer.attention",
                     lambda e: e["n_layers"] if e["type"] == "conformer_stft" else 0,
                     layers.attention_work)


def ffn_roofline(view):
    """The dense feed-forwards' share of their roofline (%): two a layer,
    their operations at the padded frames and bytes, over the
    ``transformer.ffn`` spans' device time."""
    return _roofline(view, "transformer.ffn",
                     lambda e: 2 * e["n_layers"] if e["type"] == "conformer_stft"
                     and e["ffn_type"] == "dense" else 0, layers.ffn_work)


def launch_idle_share(view):
    """Share of the traced window in which the device ran nothing while the
    host was inside ``conformer.backbone`` (%): each idle gap labelled by
    the innermost aligned port span around its middle, as
    ``TraceView.idle_gaps`` labels by the harness's spans."""
    records = port_records()
    got = window_calls(view, records)
    if got is None or view.window_s <= 0:
        return None
    pairs, to_us, residuals = got
    if statistics.median(residuals) > MAX_RESIDUAL_US:
        return None
    calls = {r.id for r, _, _ in pairs}
    recs = [r for r in records if r.call in calls]
    by_id = {r.id: r for r in recs}

    def in_backbone(r):
        while r is not None:
            if r.name == BACKBONE:
                return True
            r = by_id.get(r.parent)
        return False

    host = [(BACKBONE if in_backbone(r) else r.name, to_us(r.start_ns), to_us(r.end_ns))
            for r in recs]
    if not any(label == BACKBONE for label, _, _ in host):
        return None
    gaps = TraceView.idle_gaps(SimpleNamespace(events=view.events, window_us=view.window_us,
                                               host=host))
    return 100.0 * sum(s for label, s in gaps if label == BACKBONE) / view.window_s


# Every tokenize reader is found under its metric's prefix in ``_tokenize``'s
# namespace (``tests/test_portbench_readers.py::test_every_metric_file_reads``);
# these four are bound there from here.
for _read in (lstm_roofline, attention_roofline, ffn_roofline, launch_idle_share):
    setattr(_tokenize, _read.__name__, _read)
