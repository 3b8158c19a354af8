"""Loaders for the normative AV1 constant tables in ``rav1e_tpu/data``.

The archives are produced by ``tools/extract_tables.py`` and
``tools/gen_tx_programs.py`` — see those for provenance (AV1 spec default
CDFs, quantizer lookups, scan orders, and traced inverse-transform op
programs).  Everything here is loaded once and treated as immutable.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

_DATA = Path(__file__).resolve().parent / "data"


@functools.lru_cache(None)
def _load(name: str):
    return np.load(_DATA / name)


@functools.lru_cache(None)
def default_cdf(name: str) -> np.ndarray:
    """Default mode CDFs (spec 9.4), inverted-Q15 runtime layout."""
    return _load("default_cdfs.npz")[name]


@functools.lru_cache(None)
def token_cdf(name: str) -> np.ndarray:
    """Default coefficient CDFs, indexed [qctx][...]."""
    return _load("token_cdfs.npz")[name]


@functools.lru_cache(None)
def quant_table(name: str) -> np.ndarray:
    return _load("quant_tables.npz")[name]


# ---------------------------------------------------------------------------
# Quantizer lookups (spec 7.12.2; reference quantize/mod.rs:37-49)
# ---------------------------------------------------------------------------

def _q_table(kind: str, bit_depth: int) -> np.ndarray:
    suffix = {8: "", 10: "_10", 12: "_12"}[bit_depth]
    return quant_table(f"{kind}_qlookup{suffix}_Q3")


def dc_q(qindex: int, delta_q: int, bit_depth: int) -> int:
    t = _q_table("dc", bit_depth)
    return int(t[min(max(qindex + delta_q, 0), 255)])


def ac_q(qindex: int, delta_q: int, bit_depth: int) -> int:
    t = _q_table("ac", bit_depth)
    return int(t[min(max(qindex + delta_q, 0), 255)])


def select_qi(quantizer: int, kind: str, bit_depth: int) -> int:
    """Closest qindex (log domain) for a Q3 quantizer value
    (reference quantize/mod.rs:52-77)."""
    t = _q_table(kind, bit_depth)
    if quantizer < int(t[0]):
        return 0
    if quantizer >= int(t[255]):
        return 255
    qi = int(np.searchsorted(t, quantizer))
    if int(t[qi]) == quantizer:
        return qi
    if quantizer * quantizer < int(t[qi - 1]) * int(t[qi]):
        return qi - 1
    return qi


def select_dc_qi(quantizer: int, bit_depth: int) -> int:
    return select_qi(quantizer, "dc", bit_depth)


def select_ac_qi(quantizer: int, bit_depth: int) -> int:
    return select_qi(quantizer, "ac", bit_depth)


# ---------------------------------------------------------------------------
# Scan orders (spec orientation; see tools/extract_tables.py)
# ---------------------------------------------------------------------------


@functools.lru_cache(None)
def scan_order(w: int, h: int, kind: str) -> np.ndarray:
    """Scan table for a ``w x h`` coefficient block (w,h <= 32).

    ``kind``: "default" (zigzag 2-D), "mrow" (horizontal class),
    "mcol" (vertical class).  Returned indices are row-major positions into
    the spec-orientation block; index i of the array = i-th scanned position.
    """
    s = _load("scan_orders.npz")
    # extraction stored under the reference's transposed naming: its AxB
    # table (converted to spec layout) covers our (w=B? ) — resolve by size.
    for key in (f"{kind}_scan_{w}x{h}", f"{kind}_scan_{h}x{w}"):
        if key in s.files:
            arr = s[key]
            if arr.size == w * h:
                # verify orientation: indices must be < w*h and the mcol scan
                # must walk columns in spec layout. We simply trust size here;
                # orientation is pinned by tests.
                return arr
    raise KeyError(f"no scan table for {w}x{h}")


# ---------------------------------------------------------------------------
# Inverse transform op programs (tools/gen_tx_programs.py)
# ---------------------------------------------------------------------------


@functools.lru_cache(None)
def inv_tx_program(name: str) -> dict:
    """Node table for a 1-D inverse transform, e.g. ``dct8``, ``adst16``."""
    z = _load("inv_tx_programs.npz")
    return {
        k: z[f"{name}__{k}"] for k in ("kind", "a", "b", "w0", "w1", "aux", "out")
    }
