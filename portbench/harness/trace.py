"""The traced window: ``torch.profiler`` over the window, the device events
it saw, the union of their spans (busy time), the idle gaps labelled by the
harness's host span they fall in, and the views the per-layer readers take.

The span arithmetic is ``chip_smoke.py``'s ``device_profile``, copied: the
device events as the card ran them (kernels, copies, sets), their union
as busy time, the rest of the window as idle.
"""
from __future__ import annotations

import contextlib
import warnings

SPAN_PREFIX = "portbench."
TOP = 10


@contextlib.contextmanager
def capture(enabled: bool):
    """A profiler over the body when ``enabled`` (yields it), else None."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    warnings.filterwarnings("ignore", message=".*Profiler clears events.*")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof
        torch.cuda.synchronize()


def union_us(spans) -> float:
    """Length of the union of (start, end) spans: streams may overlap."""
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(spans):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


class TraceView:
    """What the readers read: ``events`` [(name, start us, end us)] of the
    device inside the window, ``window_us`` (start, end), ``busy_s``,
    ``window_s``, the entry's ``work`` log of the window, the ``config``
    dict, and ``kernel_s(match)``."""

    def __init__(self, prof, entry, config: dict):
        from torch.autograd import DeviceType

        events = prof.events()
        host, device = [], []
        for e in events:
            if e.name.startswith(SPAN_PREFIX) and e.device_type == DeviceType.CUDA:
                continue  # the harness's own ranges, mirrored on the device's timeline
            if e.device_type == DeviceType.CUDA:
                device.append((e.name, float(e.time_range.start), float(e.time_range.end)))
            elif e.name.startswith(SPAN_PREFIX):
                host.append((e.name[len(SPAN_PREFIX):], float(e.time_range.start),
                             float(e.time_range.end)))
        window = [h for h in host if h[0] == "window"]
        self.window_us = (window[0][1], window[0][2])
        w0, w1 = self.window_us
        self.events = [(n, max(a, w0), min(b, w1)) for n, a, b in device if b > w0 and a < w1]
        self.host = [h for h in host if h[0] != "window"]
        self.window_s = (w1 - w0) / 1e6
        self.busy_s = union_us([(a, b) for _, a, b in self.events]) / 1e6
        self.work = list(entry.work)
        self.config = config

    def kernel_s(self, match) -> float:
        """Seconds of the device events whose name contains ``match``."""
        return sum(b - a for n, a, b in self.events if match in n) / 1e6

    def idle_gaps(self):
        """(label, seconds) of each gap in the device's work inside the
        window, the label the innermost host span around its middle."""
        gaps, end = [], self.window_us[0]
        for _, a, b in sorted(self.events, key=lambda e: e[1]):
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if self.window_us[1] > end:
            gaps.append((end, self.window_us[1]))
        out = []
        for a, b in gaps:
            mid = (a + b) / 2
            inside = [h for h in self.host if h[1] <= mid <= h[2]]
            label = min(inside, key=lambda h: h[2] - h[1])[0] if inside else "between_spans"
            out.append((label, (b - a) / 1e6))
        return out

    def breakdown(self) -> dict:
        by_name = {}
        for n, a, b in self.events:
            by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        idle = {}
        for label, s in self.idle_gaps():
            idle[label] = idle.get(label, 0.0) + s
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}
