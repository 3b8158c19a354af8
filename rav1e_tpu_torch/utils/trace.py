"""Tracing & profiling hooks.

Capability counterpart of the reference's ``profiling`` attributes +
``tracing-chrome`` subscriber (reference Cargo.toml:64-69, doc/PROFILING.md):
every pipeline stage emits spans; when enabled they are collected as
chrome://tracing "X" (complete) events and written as JSON.

Enable with env ``RAV1E_TPU_TRACE=/path/out.json`` or programmatically via
:func:`trace_enable`.  Span collection also powers the CLI ``--benchmark``
per-stage summary (:func:`stage_summary`).
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from contextlib import contextmanager
from functools import wraps
from typing import Dict, List, Optional

_events: List[dict] = []
_enabled = False
_out_path: Optional[str] = None
_lock = threading.Lock()
_t0 = time.monotonic()


def _maybe_env_init() -> None:
    global _enabled, _out_path
    path = os.environ.get("RAV1E_TPU_TRACE")
    if path and not _enabled:
        _enabled = True
        _out_path = path
        atexit.register(trace_write)


def trace_enable(path: Optional[str] = None) -> None:
    """Turn span collection on (optionally writing JSON to ``path`` at exit)."""
    global _enabled, _out_path
    _enabled = True
    if path:
        _out_path = path
        atexit.register(trace_write)


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


@contextmanager
def span(name: str, **args):
    if not _enabled:
        yield
        return
    start = time.monotonic()
    try:
        yield
    finally:
        dur = time.monotonic() - start
        with _lock:
            _events.append({
                "name": name,
                "ph": "X",
                "ts": (start - _t0) * 1e6,
                "dur": dur * 1e6,
                "pid": os.getpid(),
                "tid": threading.get_ident() % 1_000_000,
                "args": args or {},
            })


def traced(name: Optional[str] = None):
    """Decorator form of :func:`span` (reference: ``#[profiling::function]``)."""

    def deco(fn):
        label = name or fn.__qualname__

        @wraps(fn)
        def wrapper(*a, **kw):
            if not _enabled:
                return fn(*a, **kw)
            with span(label):
                return fn(*a, **kw)

        return wrapper

    return deco


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


def reset() -> None:
    with _lock:
        _events.clear()


_maybe_env_init()
