"""Distortion kernels: SAD / SATD / weighted SSE / cdef-dist.

Counterpart of the reference's ``src/dist.rs`` (the ME/RDO hot kernels).
Vectorized over tiled Hadamard transforms — on device these are batched
(H @ D @ H^T) matmuls on the MXU; the host path uses the same batched
numpy expression.
"""

from __future__ import annotations

import functools

import numpy as np


def get_sad(a: np.ndarray, b: np.ndarray) -> int:
    """Sum of absolute differences (dist.rs:31)."""
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).sum())


@functools.lru_cache(None)
def _hadamard(n: int) -> np.ndarray:
    h = np.array([[1]], dtype=np.int64)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


def get_satd(a: np.ndarray, b: np.ndarray) -> int:
    """Sum of absolute Hadamard-transformed differences (dist.rs:156-221).

    4x* / *x4 blocks use the 4x4 transform, everything else 8x8; partial
    edge chunks fall back to SAD; result normalized by log2(size).
    """
    h, w = a.shape
    size = min(w, h, 8)
    H = _hadamard(size)
    total = 0
    for cy in range(0, h, size):
        ch = min(h - cy, size)
        for cx in range(0, w, size):
            cw = min(w - cx, size)
            da = a[cy : cy + ch, cx : cx + cw].astype(np.int64)
            db = b[cy : cy + ch, cx : cx + cw].astype(np.int64)
            if cw != size or ch != size:
                total += int(np.abs(da - db).sum())
                continue
            d = da - db
            t = H @ d @ H
            total += int(np.abs(t).sum())
    ln = size.bit_length() - 1
    return (total + (1 << ln >> 1)) >> ln


def get_satd_batch(diffs: np.ndarray) -> np.ndarray:
    """Batched SATD over (N, s, s) difference blocks (s in {4, 8}) — the
    MXU-shaped form used by batched mode decision."""
    n, s, _ = diffs.shape
    H = _hadamard(s)
    t = np.einsum("ij,njk,kl->nil", H, diffs.astype(np.int64), H)
    ln = s.bit_length() - 1
    return (np.abs(t).sum(axis=(1, 2)) + (1 << ln >> 1)) >> ln


GET_WEIGHTED_SSE_SHIFT = 8


def get_weighted_sse(a: np.ndarray, b: np.ndarray, scale: np.ndarray) -> int:
    """Distortion-scaled SSE; each fixed-point scale covers a 4x4 cell
    (dist.rs:234-300)."""
    h, w = a.shape
    d = (a.astype(np.int64) - b.astype(np.int64)) ** 2
    h4, w4 = (h + 3) // 4, (w + 3) // 4
    total = 0
    for cy in range(h4):
        for cx in range(w4):
            cell = d[cy * 4 : cy * 4 + 4, cx * 4 : cx * 4 + 4]
            total += int(cell.sum()) * int(scale[cy, cx])
    return (total + (1 << GET_WEIGHTED_SSE_SHIFT >> 1)) >> GET_WEIGHTED_SSE_SHIFT


def cdef_dist_kernel(src: np.ndarray, dst: np.ndarray, bd: int) -> int:
    """SSIM-boosted distortion over 8x8 cells (dist.rs:302-380 behavioral
    counterpart; used by the loop-filter RDO)."""
    h, w = src.shape
    total = 0.0
    for cy in range(0, h, 8):
        for cx in range(0, w, 8):
            s = src[cy : cy + 8, cx : cx + 8].astype(np.float64)
            d = dst[cy : cy + 8, cx : cx + 8].astype(np.float64)
            sse = ((s - d) ** 2).sum()
            svar = s.var()
            dvar = d.var()
            c2 = (0.03 * ((1 << bd) - 1)) ** 2
            boost = (2.0 * (svar * dvar) ** 0.5 + c2) / (svar + dvar + c2)
            total += sse * boost
    return int(round(total))
