"""Segmentation: activity-clustered per-segment quantizer offsets.

Counterpart of the reference's ``src/segmentation.rs``: k-means over
log-activity scales selects up to 8 segments whose SEG_LVL_ALT_Q deltas
retarget the quantizer (``Q' = Q / sqrt(scale)``, segmentation.rs:76-140);
per-4x4 segment ids are derived from the dominant segment of each block's
activity region.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from rav1e_tpu_torch import tables

SEG_LVL_ALT_Q = 0
MAX_SEGMENTS = 8


@dataclass
class SegmentationState:
    enabled: bool = False
    update_map: bool = True
    update_data: bool = True
    last_active_segid: int = 0
    preskip: bool = False
    features: List[List[bool]] = field(
        default_factory=lambda: [[False] * 8 for _ in range(MAX_SEGMENTS)]
    )
    data: List[List[int]] = field(
        default_factory=lambda: [[0] * 8 for _ in range(MAX_SEGMENTS)]
    )
    # per-mi segment map (rows, cols) uint8
    seg_map: np.ndarray = None

    def qidx(self, base_q_idx: int, seg_id: int) -> int:
        if not self.enabled:
            return base_q_idx
        d = self.data[seg_id][SEG_LVL_ALT_Q] if self.features[seg_id][SEG_LVL_ALT_Q] else 0
        return max(1, min(base_q_idx + d, 255))


def _kmeans1d(values: np.ndarray, k: int, iters: int = 12) -> np.ndarray:
    """1-D k-means (counterpart of util/kmeans.rs)."""
    vmin, vmax = float(values.min()), float(values.max())
    if vmax - vmin < 1e-9:
        return np.array([vmin] * k)
    cents = np.linspace(vmin, vmax, k)
    for _ in range(iters):
        assign = np.argmin(np.abs(values[:, None] - cents[None, :]), axis=1)
        sums = np.bincount(assign, weights=values, minlength=k)
        counts = np.bincount(assign, minlength=k)
        nz = counts > 0
        # empty clusters keep their previous centroid
        cents[nz] = sums[nz] / counts[nz]
    return np.sort(cents)


def _seg_cell_stats(luma_src: np.ndarray, ref_luma):
    """Integer per-8x8 stats: (sum, sum-of-squares, SAD-vs-ref or None).

    Native single pass (enc_seg_stats) with a bit-identical numpy mirror —
    both produce exact int64 sums, so the derived floats cannot differ."""
    h8, w8 = luma_src.shape[0] // 8, luma_src.shape[1] // 8
    from rav1e_tpu_torch import native

    lib = native.get_lib()
    has_ref = ref_luma is not None and ref_luma.shape == luma_src.shape
    if (
        lib is not None
        and luma_src.itemsize in (1, 2)
        and luma_src.strides[1] == luma_src.itemsize
        and (not has_ref or ref_luma.strides[1] == ref_luma.itemsize)
        and (not has_ref or ref_luma.itemsize == luma_src.itemsize)
    ):
        s = np.empty((h8, w8), np.int64)
        q = np.empty((h8, w8), np.int64)
        sad = np.empty((h8, w8), np.int64) if has_ref else None
        lib.enc_seg_stats(
            luma_src.ctypes.data, luma_src.strides[0] // luma_src.itemsize,
            ref_luma.ctypes.data if has_ref else None,
            (ref_luma.strides[0] // ref_luma.itemsize) if has_ref else 0,
            luma_src.itemsize, h8 * 8, w8 * 8,
            s.ctypes.data, q.ctypes.data,
            sad.ctypes.data if has_ref else None,
        )
        return s, q, sad
    x = luma_src[: h8 * 8, : w8 * 8].astype(np.int64)
    cells = x.reshape(h8, 8, w8, 8)
    s = cells.sum(axis=(1, 3))
    q = (cells * cells).sum(axis=(1, 3))
    sad = None
    if has_ref:
        d = np.abs(x - ref_luma[: h8 * 8, : w8 * 8].astype(np.int64))
        sad = d.reshape(h8, 8, w8, 8).sum(axis=(1, 3))
    return s, q, sad


def segmentation_optimize(
    luma_src: np.ndarray, base_q_idx: int, bit_depth: int, mi_cols: int,
    mi_rows: int, nseg: int = 3, ref_luma: np.ndarray = None,
    imp_scales: np.ndarray = None,
) -> SegmentationState:
    """Build segment ΔQ table + per-mi map from source activity and (for
    inter frames) temporal predictability — the spatiotemporal-score analog
    of segmentation.rs:23-160: well-predicted static regions earn lower q
    because their quality propagates through the reference chain."""
    st = SegmentationState()
    h8, w8 = luma_src.shape[0] // 8, luma_src.shape[1] // 8
    if h8 * w8 < nseg:
        return st
    ssum, qsum, sad = _seg_cell_stats(luma_src, ref_luma)
    scale = float(1 << (bit_depth - 8))
    # per-cell variance of x = raw/scale: (64*q - s^2) / 4096 / scale^2
    act = (64.0 * qsum - ssum.astype(np.float64) ** 2) / (4096.0 * scale * scale)
    logs = 0.5 * np.log2(np.maximum(act, 1.0))
    if sad is not None:
        terr = sad / (64.0 * scale)
        logs = logs + 0.5 * np.log2(np.maximum(terr, 0.25) / 4.0)
    if imp_scales is not None:
        # temporal-RDO importance: heavily-referenced cells behave like
        # low-activity ones — lower q so their quality propagates
        # (internal.rs block_importances -> distortion_scale path)
        h8, w8 = logs.shape
        sc = imp_scales[:h8, :w8]
        if sc.shape != logs.shape:
            pad = np.ones_like(logs)
            pad[: sc.shape[0], : sc.shape[1]] = sc
            sc = pad
        logs = logs - 1.5 * np.log2(np.maximum(sc, 1.0))
    cents = _kmeans1d(logs.reshape(-1), nseg)
    if cents[-1] - cents[0] < 0.5:
        return st  # flat content: not worth the signaling

    # ΔQ per segment: Q' = Q * sqrt(scale_rel) where scale_rel is the
    # centroid's activity relative to the median segment (high activity ->
    # masking -> higher q)
    base_q = tables.ac_q(base_q_idx, 0, bit_depth)
    mid = float(np.median(cents))
    deltas = []
    for c in cents:
        target = base_q * (2.0 ** (0.35 * (c - mid)))
        qi = max(tables.select_ac_qi(int(round(target)), bit_depth), 1)
        deltas.append(int(qi) - base_q_idx)
    st.enabled = True
    st.last_active_segid = nseg - 1
    for i, d in enumerate(deltas):
        st.features[i][SEG_LVL_ALT_Q] = True
        st.data[i][SEG_LVL_ALT_Q] = max(d, 1 - base_q_idx)

    # per-mi map: nearest centroid of the covering 8x8 activity cell
    assign8 = np.argmin(np.abs(logs[:, :, None] - cents[None, None, :]), axis=2)
    ys = np.minimum(np.arange(mi_rows) // 2, assign8.shape[0] - 1)
    xs = np.minimum(np.arange(mi_cols) // 2, assign8.shape[1] - 1)
    st.seg_map = assign8[ys[:, None], xs[None, :]].astype(np.uint8)
    return st


def neg_interleave(x: int, r: int, mx: int) -> int:
    """(partition_unit.rs:359-386)"""
    assert x < mx
    if r == 0:
        return x
    if r >= mx - 1:
        return -x + mx - 1
    diff = x - r
    if 2 * r < mx:
        if abs(diff) <= r:
            return (diff << 1) - 1 if diff > 0 else (-diff) << 1
        return x
    if abs(diff) < (mx - r):
        return (diff << 1) - 1 if diff > 0 else (-diff) << 1
    return (mx - x) - 1


def neg_deinterleave(diff: int, ref: int, mx: int) -> int:
    """Inverse of :func:`neg_interleave` (spec 5.11.57 neg_deinterleave)."""
    if ref == 0:
        return diff
    if ref >= mx - 1:
        return mx - diff - 1
    if 2 * ref < mx:
        if diff <= 2 * ref:
            if diff & 1:
                return ref + ((diff + 1) >> 1)
            return ref - (diff >> 1)
        return diff
    if diff <= 2 * (mx - ref - 1):
        if diff & 1:
            return ref + ((diff + 1) >> 1)
        return ref - (diff >> 1)
    return mx - (diff + 1)
