"""Spans of the port's own layers, kept in the port's memory.

``span(name, device=None)`` is a context manager around one layer's work.
It is off unless ``torch.profiler`` is recording (torch's own check) or a
``recording()`` block is open; off, it returns one shared no-op context
and reads no clock. On, it appends a ``Record`` to a bounded list (the
oldest dropped past ``LIMIT``):

- ``name``;
- ``start_ns`` / ``end_ns``: ``time.time_ns()``, the clock the profiler
  stamps its host events with (CLOCK_REALTIME on Linux), so one constant
  offset places a span on a profiler trace;
- ``parent``: the id of the span it opened inside, or None; ``call``: the
  id of the outermost open span (a ``ragged.call`` on the tokenize path),
  shared by every span of that call;
- with ``device`` a CUDA device, two timing events recorded at entry and
  exit on the stream current at entry: ``Record.device_s`` is the stretch
  of that stream the span's work took, its kernels and the gaps between
  them. It waits for nothing: read it once the caller has synchronized.

A span holds no count of its work: the work is known from the inputs of
the call it belongs to. The spans are not
``torch.profiler.record_function`` ranges: the profiler mirrors those
onto the device's timeline, where they would read as device work.
Nothing here syncs the device.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time

import torch

LIMIT = 1 << 15  # records kept; older ones are dropped

_RECORDS = collections.deque(maxlen=LIMIT)
_IDS = itertools.count(1)
_LOCAL = threading.local()  # this thread's open spans
_FORCED = [0]  # open recording() blocks


class Record:
    """One span: the fields of the module docstring."""

    __slots__ = ("id", "name", "parent", "call", "start_ns", "end_ns", "events")

    def __init__(self, id, name, parent, call):
        self.id, self.name, self.parent, self.call = id, name, parent, call
        self.start_ns = self.end_ns = self.events = None

    @property
    def device_s(self):
        """Seconds of the device's stream between the span's two events;
        None without events. Only after the device has passed both."""
        if self.events is None:
            return None
        return self.events[0].elapsed_time(self.events[1]) / 1e3


def _stack() -> list:
    try:
        return _LOCAL.stack
    except AttributeError:
        _LOCAL.stack = []
        return _LOCAL.stack


class _Off:
    """The shared no-op span."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, typ, value, tb):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "device", "record", "stream")

    def __init__(self, name, device):
        self.name, self.device = name, device

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        rec = Record(next(_IDS), self.name, parent and parent.id, parent and parent.call)
        if rec.call is None:
            rec.call = rec.id
        if self.device is not None and torch.device(self.device).type == "cuda":
            self.stream = torch.cuda.current_stream(self.device)
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record(self.stream)
        _RECORDS.append(rec)
        stack.append(rec)
        self.record = rec
        rec.start_ns = time.time_ns()
        return rec

    def __exit__(self, *exc):
        rec = self.record
        rec.end_ns = time.time_ns()
        if rec.events is not None:
            rec.events[1].record(self.stream)
        _stack().pop()
        return False


_profiling = torch._C._autograd._profiler_enabled  # torch's own check


def span(name: str, device=None):
    """A span of ``name``; with ``device`` a CUDA device, its stream time
    too (module docstring). Off: the shared no-op."""
    if not (_FORCED[0] or _profiling()):
        return _OFF
    return _Span(name, device)


class recording:
    """Spans record inside this block, with or without the profiler."""

    def __enter__(self):
        _FORCED[0] += 1
        return self

    def __exit__(self, *exc):
        _FORCED[0] -= 1
        return False


def records() -> list:
    """The kept records, oldest first (each appended when its span opened)."""
    return list(_RECORDS)


def clear():
    _RECORDS.clear()
