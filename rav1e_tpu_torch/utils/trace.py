"""Tracing & profiling hooks.

Capability counterpart of the reference's ``profiling`` attributes +
``tracing-chrome`` subscriber (reference Cargo.toml:64-69, doc/PROFILING.md):
every pipeline stage emits spans; when enabled they are collected as
chrome://tracing events and written as JSON.

- **Clock.** A span starts and ends on ``time.monotonic``; an event's
  ``ts`` counts microseconds from this module's import, its ``dur``
  microseconds. A caller that reads the monotonic clock lines its own times
  up with the spans through one span of its own.
- **Format.** Every event is an ``"X"`` (complete) event with a ``dur``,
  whatever it records. A counter is a zero-length span
  (``chain_predispatch_hit``, ``chain_overflow``, ``chain_diverged``,
  ``inter_chain``, ``inter_host``), so a reader takes each event's
  ``name``, ``ts`` and ``dur`` and nothing else.
- **Times past.** :func:`complete` records a span or counter whose start
  was taken earlier: ``receive_packet`` marks each shown frame's time in
  flight as the counters ``frame_in_flight_start`` (at its ``send_frame``)
  and ``frame_in_flight_end``, recorded one right after the other. They
  have no profiler range.
- **Python's garbage collector.** While tracing is on, each collection is
  a ``py_gc`` span from ``gc.callbacks``' start to its stop, with the
  collection's ``generation`` and ``collected`` count as args.
- **Profiler bridge.** While tracing is on and a ``torch.profiler``
  session is recording, each span also opens a profiler range of its name,
  so the profiler's exported trace holds the spans beside the CUDA runtime
  calls and the kernels, on the profiler's own clock. The ranges are
  host-side only: they add no record to the device's timeline.
- **Off**, :func:`span` tests one flag (``_enabled``) and touches neither
  torch nor ``gc``.

Enable with env ``RAV1E_TPU_TRACE=/path/out.json`` or programmatically via
:func:`trace_enable`; :func:`trace_disable` turns collection off and takes
the ``gc`` callback away. Span collection also powers the CLI
``--benchmark`` per-stage summary (:func:`stage_summary`).
"""

from __future__ import annotations

import atexit
import gc
import json
import os
import sys
import threading
import time
from contextlib import nullcontext
from typing import Dict, List, Optional

_events: List[dict] = []
_enabled = False
_out_path: Optional[str] = None
# re-entrant: a collection, and so a py_gc span, can start on a thread
# that holds the lock
_lock = threading.RLock()
_t0 = time.monotonic()
_OFF = nullcontext()
_gc_start: Optional[float] = None


def _maybe_env_init() -> None:
    path = os.environ.get("RAV1E_TPU_TRACE")
    if path and not _enabled:
        trace_enable(path)


def trace_enable(path: Optional[str] = None) -> None:
    """Turn span collection on (optionally writing JSON to ``path`` at exit)
    and time Python's garbage collections as ``py_gc`` spans."""
    global _enabled, _out_path
    _enabled = True
    if _on_gc not in gc.callbacks:
        gc.callbacks.append(_on_gc)
    if path:
        _out_path = path
        atexit.register(trace_write)


def trace_disable() -> None:
    """Turn span collection off and remove the ``gc`` callback; the events
    collected so far stay until :func:`reset`."""
    global _enabled, _gc_start
    _enabled = False
    _gc_start = None
    if _on_gc in gc.callbacks:
        gc.callbacks.remove(_on_gc)


def trace_enabled() -> bool:
    return _enabled


def trace_write(path: Optional[str] = None) -> Optional[str]:
    """Write collected events as a chrome://tracing JSON array."""
    p = path or _out_path
    if not p:
        return None
    with _lock:
        data = {"traceEvents": list(_events)}
    with open(p, "w") as f:
        json.dump(data, f)
    return p


def _record(name: str, start: float, end: float, args: dict) -> None:
    ev = {
        "name": name,
        "ph": "X",
        "ts": (start - _t0) * 1e6,
        "dur": (end - start) * 1e6,
        "pid": os.getpid(),
        "tid": threading.get_ident() % 1_000_000,
        "args": args,
    }
    with _lock:
        _events.append(ev)


def _on_gc(phase: str, info: dict) -> None:
    """``gc.callbacks`` entry: a collection's start and stop as one span.
    Tests the flag itself, since tests set ``_enabled`` directly."""
    global _gc_start
    if not _enabled:
        return
    if phase == "start":
        _gc_start = time.monotonic()
    elif _gc_start is not None:
        start, _gc_start = _gc_start, None
        _record("py_gc", start, time.monotonic(),
                {"generation": info["generation"],
                 "collected": info["collected"]})


def _profiler_range(name: str):
    """A host-side profiler range of ``name`` when a ``torch.profiler``
    session is recording, else None.  ``_RecordFunctionFast`` rather than
    ``record_function``: a user-scope range also makes the profiler write a
    ``gpu_user_annotation`` record of the same name on the device's
    timeline, spanning the kernels launched inside it, which would count as
    device activity to anyone reading that timeline."""
    torch = sys.modules.get("torch")
    if torch is None or not torch._C._autograd._profiler_enabled():
        return None
    rf = torch._C._profiler._RecordFunctionFast(name)
    rf.__enter__()
    return rf


class _Span:
    __slots__ = ("name", "args", "start", "rf")

    def __init__(self, name: str, args: dict):
        self.name, self.args = name, args

    def __enter__(self):
        self.rf = _profiler_range(self.name)
        self.start = time.monotonic()

    def __exit__(self, *exc):
        end = time.monotonic()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        _record(self.name, self.start, end, self.args)
        return False


def span(name: str, **args):
    """A context manager timing its body as the span ``name`` (with
    ``args``) while tracing is on; a shared no-op one while it is off."""
    if not _enabled:
        return _OFF
    return _Span(name, args)


def complete(name: str, start: float, end: float, **args) -> None:
    """Record the span ``name`` from ``start`` to ``end`` (both on
    ``time.monotonic``, both past; equal for a counter) while tracing is
    on."""
    if _enabled:
        _record(name, start, end, args)


def stage_summary() -> Dict[str, dict]:
    """Aggregate span durations by name -> {count, total_ms, mean_ms}."""
    agg: Dict[str, List[float]] = {}
    with _lock:
        for e in _events:
            agg.setdefault(e["name"], []).append(e["dur"] / 1e3)
    return {
        k: {"count": len(v), "total_ms": round(sum(v), 2),
            "mean_ms": round(sum(v) / len(v), 3)}
        for k, v in sorted(agg.items())
    }


def covered_s(t0: float, t1: float) -> float:
    """Seconds of ``[t0, t1]`` (on the monotonic clock) inside at least one
    collected span."""
    with _lock:
        ivs = sorted((max(_t0 + e["ts"] / 1e6, t0),
                      min(_t0 + (e["ts"] + e["dur"]) / 1e6, t1))
                     for e in _events)
    covered, end = 0.0, t0
    for a, b in ivs:
        if b > max(a, end):
            covered += b - max(a, end)
            end = b
    return covered


def reset() -> None:
    with _lock:
        _events.clear()


_maybe_env_init()
