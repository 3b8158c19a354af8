"""Desync finder: symbol-level encoder/decoder trace comparison.

Counterpart of the reference's ``desync_finder`` feature (reference
ec.rs:322-410, env ``RAV1E_DEBUG``): when ``RAV1E_TPU_DEBUG`` is set, every
coded symbol is recorded on both sides; :func:`compare_traces` reports the
first point of divergence — the fastest way to localize a bitstream desync.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

_enabled = bool(os.environ.get("RAV1E_TPU_DEBUG"))
_enc_trace: List[int] = []
_dec_trace: List[int] = []


def enabled() -> bool:
    return _enabled


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def reset() -> None:
    _enc_trace.clear()
    _dec_trace.clear()


def log_symbol(side: str, s: int) -> None:
    (_enc_trace if side == "enc" else _dec_trace).append(int(s))


def traces() -> Tuple[List[int], List[int]]:
    return _enc_trace, _dec_trace


def compare_traces() -> Optional[int]:
    """Returns the index of the first mismatching symbol, or None if the
    decoder trace is a prefix-consistent match."""
    n = min(len(_enc_trace), len(_dec_trace))
    for i in range(n):
        if _enc_trace[i] != _dec_trace[i]:
            return i
    if len(_dec_trace) > len(_enc_trace):
        return len(_enc_trace)
    return None
