"""What a traced run reads from ``torch.profiler``: the device's activity
over the window, by kernel and as a union of intervals, on the host's
monotonic clock so that it lines up with the program's spans.
"""

from __future__ import annotations

import time

MARK = "encbench.window_start"


class DeviceTrace:
    """Profile the window: ``start()`` before its first frame, ``stop()``
    after its last; then ``events`` holds the device activities as (name,
    start s, end s) on ``time.monotonic``'s clock."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._mark_ns = None
        self.events = []

    def start(self):
        from torch.profiler import record_function

        self._prof.__enter__()
        self._mark_ns = time.monotonic_ns()
        with record_function(MARK):
            pass

    def stop(self):
        import torch

        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        cuda = torch.autograd.DeviceType.CUDA
        evs = list(self._prof.profiler.kineto_results.events())
        marks = [e for e in evs if e.name() == MARK]
        # the profiler's clock against the monotonic clock, from the mark
        off = (marks[0].start_ns() - self._mark_ns) if marks else 0
        self.events = sorted(
            ((e.name(), (e.start_ns() - off) / 1e9,
              (e.start_ns() - off + e.duration_ns()) / 1e9)
             for e in evs if e.device_type() == cuda), key=lambda x: x[1])
        self._prof = None


def merged(intervals):
    out = []
    for s0, s1 in sorted(intervals):
        if out and s0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], s1)
        else:
            out.append([s0, s1])
    return out


def clip(intervals, t0, t1):
    return [(max(a, t0), min(b, t1)) for a, b in intervals
            if b > t0 and a < t1]


def busy_s(events, t0, t1) -> float:
    return sum(b - a for a, b in merged(clip([(e[1], e[2]) for e in events],
                                             t0, t1)))


def by_name(events, t0, t1):
    """{kernel or operation name: (seconds inside the window, count)}."""
    out = {}
    for name, a, b in events:
        if b > t0 and a < t1:
            s, n = out.get(name, (0.0, 0))
            out[name] = (s + min(b, t1) - max(a, t0), n + 1)
    return out


def idle_gaps(events, t0, t1):
    """The window's intervals with no device activity, longest first."""
    busy = merged(clip([(e[1], e[2]) for e in events], t0, t1))
    gaps, at = [], t0
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if at < t1:
        gaps.append((at, t1))
    return sorted(gaps, key=lambda g: g[0] - g[1])


def open_span(spans, t):
    """The innermost (latest started) span open at time ``t``, or None."""
    best = None
    for name, a, b in spans:
        if a <= t < b and (best is None or a >= best[1]):
            best = (name, a)
    return best[0] if best else None


def host_activity(spans, api_calls, t):
    """What the host was doing at ``t``: the API call the harness was in
    and the program's innermost open span."""
    call = open_span(api_calls or [], t) or "between API calls"
    return f"{call} / {open_span(spans, t) or 'no program span'}"
