"""Intra prediction (normative; spec 7.11.2, reference src/predict.rs).

Every predictor takes an :class:`IntraEdge` — the top/left reconstruction
border — and produces the (H, W) prediction.  The reconstruction path must be
bit-exact with a conforming decoder, so all arithmetic is integer with the
spec's exact rounding.

TPU-first notes: the predictors are written as vectorized array ops (weights
precomputed per size, prediction = broadcast/outer ops) so they batch over
candidate modes during RDO via a leading axis; the wavefront-critical exact
path runs per tx block on the recon grid.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from encbench.reference.av1.partition import (
    ANGLE_STEP,
    PredictionMode,
    intra_mode_to_angle,
)

# Smooth-predictor weights (normative constants, spec 7.11.2.6 Sm_Weights;
# also reference predict.rs:604-623), indexed by block dimension.
SM_WEIGHTS = {
    4: np.array([255, 149, 85, 64], dtype=np.int32),
    8: np.array([255, 197, 146, 105, 73, 50, 37, 32], dtype=np.int32),
    16: np.array(
        [255, 225, 196, 170, 145, 123, 102, 84, 68, 54, 43, 33, 26, 20, 17, 16],
        dtype=np.int32,
    ),
    32: np.array(
        [255, 240, 225, 210, 196, 182, 169, 157, 145, 133, 122, 111, 101, 92,
         83, 74, 66, 59, 52, 45, 39, 34, 29, 25, 21, 17, 14, 12, 10, 9, 8, 8],
        dtype=np.int32,
    ),
    64: np.array(
        [255, 248, 240, 233, 225, 218, 210, 203, 196, 189, 182, 176, 169, 163,
         156, 150, 144, 138, 133, 127, 121, 116, 111, 106, 101, 96, 91, 86, 82,
         77, 73, 69, 65, 61, 57, 54, 50, 47, 44, 41, 38, 35, 32, 29, 27, 25,
         22, 20, 18, 16, 15, 13, 12, 10, 9, 8, 7, 6, 6, 5, 5, 4, 4, 4],
        dtype=np.int32,
    ),
}

# Directional intra derivative (normative, spec 7.11.2.7 Dr_Intra_Derivative;
# reference predict.rs:1268).
DR_INTRA_DERIVATIVE = {
    3: 1023, 6: 547, 9: 372, 14: 273, 17: 215, 20: 178, 23: 151, 26: 132,
    29: 116, 32: 102, 36: 90, 39: 80, 42: 71, 45: 64, 48: 57, 51: 51, 54: 45,
    58: 40, 61: 35, 64: 31, 67: 27, 70: 23, 73: 19, 76: 15, 81: 11, 84: 7,
    87: 3,
}


def _round_shift(x, bit):
    return (x + (1 << (bit - 1))) >> bit


@dataclass
class IntraEdge:
    """Edge buffer for one tx block.

    ``above``: int32 (w + h,) — row above, left-to-right, incl. top-right
               extension (replicated when unavailable).
    ``left``:  int32 (h + w,) — column left, top-to-bottom, incl. bottom-left
               extension.
    ``top_left``: int scalar.
    """

    above: np.ndarray
    left: np.ndarray
    top_left: int
    have_above: bool
    have_left: bool


@dataclass
class IefParams:
    """Intra edge filter parameters (enable_intra_edge_filter=1 path)."""

    above_mode: Optional[PredictionMode]  # neighbor modes for smooth-filter sel
    left_mode: Optional[PredictionMode]

    def use_smooth_filter(self) -> bool:
        smooth = (
            PredictionMode.SMOOTH_PRED,
            PredictionMode.SMOOTH_V_PRED,
            PredictionMode.SMOOTH_H_PRED,
        )
        return (self.above_mode in smooth) or (self.left_mode in smooth)


def predict_intra(
    mode: PredictionMode,
    edge: IntraEdge,
    w: int,
    h: int,
    bd: int,
    angle_delta: int = 0,
    alpha: int = 0,
    ac: Optional[np.ndarray] = None,
    ief_params: Optional[IefParams] = None,
) -> np.ndarray:
    """Dispatch one intra prediction -> (h, w) int32 in [0, 2^bd)."""
    # Variant resolution (reference predict.rs:229-238)
    if mode == PredictionMode.PAETH_PRED:
        if not edge.have_above and not edge.have_left:
            mode = PredictionMode.DC_PRED
        elif not edge.have_above:
            mode = PredictionMode.H_PRED
        elif not edge.have_left:
            mode = PredictionMode.V_PRED
    if mode == PredictionMode.UV_CFL_PRED and alpha == 0:
        mode = PredictionMode.DC_PRED

    if mode == PredictionMode.DC_PRED:
        return _pred_dc(edge, w, h, bd)
    if mode == PredictionMode.UV_CFL_PRED:
        dc = _pred_dc(edge, w, h, bd)
        return _pred_cfl(dc, ac, alpha, bd)
    if mode.is_directional():
        p_angle = intra_mode_to_angle(mode) + angle_delta * ANGLE_STEP
        if p_angle == 90:
            return _pred_v(edge, w, h)
        if p_angle == 180:
            return _pred_h(edge, w, h)
        return _pred_directional(edge, w, h, bd, p_angle, ief_params)
    if mode == PredictionMode.SMOOTH_PRED:
        return _pred_smooth(edge, w, h)
    if mode == PredictionMode.SMOOTH_V_PRED:
        return _pred_smooth_v(edge, w, h)
    if mode == PredictionMode.SMOOTH_H_PRED:
        return _pred_smooth_h(edge, w, h)
    if mode == PredictionMode.PAETH_PRED:
        return _pred_paeth(edge, w, h)
    raise ValueError(f"not an intra mode: {mode}")


# ---------------------------------------------------------------------------


def _pred_dc(edge: IntraEdge, w: int, h: int, bd: int) -> np.ndarray:
    if edge.have_above and edge.have_left:
        s = int(edge.above[:w].sum()) + int(edge.left[:h].sum())
        avg = (s + ((w + h) >> 1)) // (w + h)
    elif edge.have_above:
        avg = _round_shift(int(edge.above[:w].sum()), w.bit_length() - 1)
    elif edge.have_left:
        avg = _round_shift(int(edge.left[:h].sum()), h.bit_length() - 1)
    else:
        avg = 128 << (bd - 8)
    return np.full((h, w), avg, dtype=np.int32)


def _pred_v(edge: IntraEdge, w: int, h: int) -> np.ndarray:
    return np.broadcast_to(edge.above[:w].astype(np.int32), (h, w)).copy()


def _pred_h(edge: IntraEdge, w: int, h: int) -> np.ndarray:
    return np.broadcast_to(
        edge.left[:h].astype(np.int32)[:, None], (h, w)
    ).copy()


def _pred_paeth(edge: IntraEdge, w: int, h: int) -> np.ndarray:
    top = edge.above[:w].astype(np.int32)[None, :]
    left = edge.left[:h].astype(np.int32)[:, None]
    tl = np.int32(edge.top_left)
    base = left + top - tl
    p_left = np.abs(base - left)
    p_top = np.abs(base - top)
    p_tl = np.abs(base - tl)
    out = np.where(
        (p_left <= p_top) & (p_left <= p_tl),
        np.broadcast_to(left, (h, w)),
        np.where(p_top <= p_tl, np.broadcast_to(top, (h, w)), np.full((h, w), tl)),
    )
    return out.astype(np.int32)


def _pred_smooth(edge: IntraEdge, w: int, h: int) -> np.ndarray:
    top = edge.above[:w].astype(np.int32)
    left = edge.left[:h].astype(np.int32)
    right = np.int32(edge.above[w - 1])
    below = np.int32(edge.left[h - 1])
    wh = SM_WEIGHTS[h][:, None]  # weights along vertical
    ww = SM_WEIGHTS[w][None, :]
    # spec 7.11.2.6: 9-bit weighted blend of (top, below) and (left, right)
    pred = (
        wh * top[None, :]
        + (256 - wh) * below
        + ww * left[:, None]
        + (256 - ww) * right
    )
    return _round_shift(pred, 9).astype(np.int32)


def _pred_smooth_v(edge: IntraEdge, w: int, h: int) -> np.ndarray:
    top = edge.above[:w].astype(np.int32)
    below = np.int32(edge.left[h - 1])
    wh = SM_WEIGHTS[h][:, None]
    pred = wh * top[None, :] + (256 - wh) * below
    return _round_shift(pred, 8).astype(np.int32)


def _pred_smooth_h(edge: IntraEdge, w: int, h: int) -> np.ndarray:
    left = edge.left[:h].astype(np.int32)
    right = np.int32(edge.above[w - 1])
    ww = SM_WEIGHTS[w][None, :]
    pred = ww * left[:, None] + (256 - ww) * right
    return _round_shift(pred, 8).astype(np.int32)


def _pred_cfl(dc: np.ndarray, ac: np.ndarray, alpha: int, bd: int) -> np.ndarray:
    """CFL: dc + scaled luma AC (spec 7.11.5; reference predict.rs:626-643)."""
    assert ac is not None
    scaled = alpha * ac.astype(np.int32)  # alpha q3 * ac q3 -> q6
    abs_q0 = (np.abs(scaled) + 32) >> 6
    contrib = np.where(scaled < 0, -abs_q0, abs_q0)
    return np.clip(dc + contrib, 0, (1 << bd) - 1).astype(np.int32)


# ---------------------------------------------------------------------------
# Directional prediction with optional edge filtering/upsampling
# ---------------------------------------------------------------------------


def select_ief_strength(w: int, h: int, smooth_filter: bool, delta: int) -> int:
    """Edge filter strength (spec 7.11.2.9 Intra_Edge_Filter_Strength;
    reference predict.rs:1125-1185)."""
    blk_wh = w + h
    d = abs(delta)
    if smooth_filter:
        if blk_wh <= 8:
            if d >= 64:
                return 2
            if d >= 40:
                return 1
        elif blk_wh <= 16:
            if d >= 48:
                return 2
            if d >= 20:
                return 1
        elif blk_wh <= 24:
            if d >= 4:
                return 3
        else:
            return 3
    else:
        if blk_wh <= 8:
            if d >= 56:
                return 1
        elif blk_wh <= 16:
            if d >= 40:
                return 1
        elif blk_wh <= 24:
            if d >= 32:
                return 3
            if d >= 16:
                return 2
            if d >= 8:
                return 1
        elif blk_wh <= 32:
            if d >= 32:
                return 3
            if d >= 4:
                return 2
            return 1
        else:
            return 3
    return 0


def select_ief_upsample(w: int, h: int, smooth_filter: bool, delta: int) -> bool:
    """Spec 7.11.2.10 use_intra_edge_upsample (reference predict.rs:1188)."""
    blk_wh = w + h
    d = abs(delta)
    if d <= 0 or d >= 40:
        return False
    return blk_wh <= 8 if smooth_filter else blk_wh <= 16


def filter_edge(edge: np.ndarray, size: int, strength: int) -> None:
    """In-place intra edge filter (spec 7.11.2.12; reference predict.rs:1206).

    ``edge[0]`` is the top-left pixel (spec index -1); filters edge[0..size).
    """
    if strength == 0:
        return
    kernels = [[0, 4, 8, 4, 0], [0, 5, 6, 5, 0], [2, 4, 4, 4, 2]]
    k = kernels[strength - 1]
    src = edge[:size].copy()
    n = size
    for i in range(1, n):
        s = 0
        for j in range(5):
            idx = min(max(i - 2 + j, 0), n - 1)
            s += k[j] * int(src[idx])
        edge[i] = (s + 8) >> 4


def upsample_edge(edge: np.ndarray, num_px: int, bd: int) -> np.ndarray:
    """Spec 7.11.2.11 intra edge upsample (reference predict.rs:1234-1266).

    Input ``edge``: [0] = spec position -1 (top-left), [1..num_px] = samples.
    Returns a buffer of 2*num_px+1 entries where index m = upsampled spec
    position m-2 (so position p maps to index p+2).
    """
    dup = np.empty(num_px + 3, dtype=np.int64)
    dup[0] = edge[0]
    dup[1 : num_px + 2] = edge[: num_px + 1]
    dup[num_px + 2] = edge[num_px]
    out = np.empty(2 * num_px + 1, dtype=np.int64)
    out[0] = dup[0]
    for i in range(num_px):
        s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3]
        # C-style truncating division (reference uses `/ 16`, not `>> 4`)
        q = s + 8
        q = int(np.sign(q)) * (abs(int(q)) // 16)
        out[2 * i + 1] = min(max(q, 0), (1 << bd) - 1)
        out[2 * i + 2] = dup[i + 2]
    return out


def _pred_directional(
    edge: IntraEdge,
    w: int,
    h: int,
    bd: int,
    p_angle: int,
    ief_params: Optional[IefParams],
) -> np.ndarray:
    """Directional predictor (spec 7.11.2.4 steps 4-9)."""
    sample_max = (1 << bd) - 1
    enable_ief = ief_params is not None

    # native fast path (tile_pred_directional wraps the parity-tested C++
    # port in native/tile_intra.inc; the trial-RDO tier calls this tens of
    # thousands of times per frame)
    from encbench.reference.av1 import native as _native

    _lib = _native.get_lib()
    if _lib is not None and w + h <= 128 and getattr(
        _lib, "tile_pred_directional", None
    ) is not None:
        a64 = np.ascontiguousarray(edge.above, dtype=np.int64)
        l64 = np.ascontiguousarray(edge.left, dtype=np.int64)
        if len(a64) >= 1 and len(l64) >= 1:
            out = np.empty((h, w), dtype=np.int32)
            smooth = ief_params.use_smooth_filter() if enable_ief else False
            _lib.tile_pred_directional(
                a64.ctypes.data, len(a64), l64.ctypes.data, len(l64),
                int(edge.top_left), w, h, bd, p_angle, int(enable_ief),
                int(smooth), out.ctypes.data,
            )
            return out

    # Build spec-style buffers with index 0 == spec position -1 (top-left);
    # replicate the last sample when the caller supplied fewer than w+h
    # (legal when the angle doesn't reach the top-right/bottom-left).
    def _fill(src, n):
        buf = np.empty(1 + n, dtype=np.int64)
        buf[0] = edge.top_left
        m = min(len(src), n)
        buf[1 : 1 + m] = src[:m]
        if m < n:
            buf[1 + m :] = src[m - 1]
        return buf

    above_buf = _fill(edge.above, w + h)
    left_buf = _fill(edge.left, h + w)

    upsample_above = upsample_left = False
    if enable_ief:
        smooth = ief_params.use_smooth_filter()
        if p_angle != 90 and p_angle != 180:
            num_above = w + (h if p_angle < 90 else 0) + 1
            num_left = h + (w if p_angle > 180 else 0) + 1
            st_a = select_ief_strength(w, h, smooth, p_angle - 90)
            filter_edge(above_buf, num_above, st_a)
            st_l = select_ief_strength(w, h, smooth, p_angle - 180)
            filter_edge(left_buf, num_left, st_l)
        num_above = w + (h if p_angle < 90 else 0)
        num_left = h + (w if p_angle > 180 else 0)
        upsample_above = select_ief_upsample(w, h, smooth, p_angle - 90)
        if upsample_above:
            above_buf = upsample_edge(above_buf, num_above, bd)
        upsample_left = select_ief_upsample(w, h, smooth, p_angle - 180)
        if upsample_left:
            left_buf = upsample_edge(left_buf, num_left, bd)

    if p_angle < 90:
        dx = DR_INTRA_DERIVATIVE[p_angle]
        dy = 0
    elif 90 < p_angle < 180:
        dx = DR_INTRA_DERIVATIVE[180 - p_angle]
        dy = DR_INTRA_DERIVATIVE[p_angle - 90]
    else:
        dx = 0
        dy = DR_INTRA_DERIVATIVE[270 - p_angle]

    ua = 1 if upsample_above else 0
    ul = 1 if upsample_left else 0
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")

    # buffer index of spec position p is p + off (off = 2 when upsampled)
    off_a = 1 << ua
    off_l = 1 << ul

    if p_angle < 90:
        idx = (ii + 1) * dx
        base = (idx >> (6 - ua)) + (jj << ua)
        shift = ((idx << ua) >> 1) & 31
        max_base_x = (h + w - 1) << ua
        basec = np.minimum(base, max_base_x)
        a = above_buf[off_a + basec]
        b = above_buf[off_a + np.minimum(basec + 1, max_base_x)]
        v = _round_shift(a * (32 - shift) + b * shift, 5)
        v = np.where(base < max_base_x, v, above_buf[off_a + max_base_x])
        return np.clip(v, 0, sample_max).astype(np.int32)
    elif p_angle > 180:
        idx = (jj + 1) * dy
        base = (idx >> (6 - ul)) + (ii << ul)
        shift = ((idx << ul) >> 1) & 31
        max_base_y = (h + w - 1) << ul
        basec = np.minimum(base, max_base_y)
        a = left_buf[off_l + basec]
        b = left_buf[off_l + np.minimum(basec + 1, max_base_y)]
        v = _round_shift(a * (32 - shift) + b * shift, 5)
        return np.clip(v, 0, sample_max).astype(np.int32)
    else:
        # 90 < p_angle < 180: mix of above (base >= -(1<<ua)) and left
        idx_a = (jj << 6) - (ii + 1) * dx
        base_a = idx_a >> (6 - ua)
        shift_a = ((idx_a << ua) >> 1) & 31
        use_above = base_a >= -(1 << ua)
        ba = np.clip(base_a, -off_a, (w << ua))
        a_a = above_buf[np.clip(off_a + ba, 0, above_buf.size - 1)]
        b_a = above_buf[np.clip(off_a + ba + 1, 0, above_buf.size - 1)]
        v_a = _round_shift(a_a * (32 - shift_a) + b_a * shift_a, 5)

        idx_l = (ii << 6) - (jj + 1) * dy
        base_l = idx_l >> (6 - ul)
        shift_l = ((idx_l << ul) >> 1) & 31
        bl = np.clip(base_l, -off_l, (h + w - 1) << ul)
        a_l = left_buf[np.clip(off_l + bl, 0, left_buf.size - 1)]
        b_l = left_buf[np.clip(off_l + bl + 1, 0, left_buf.size - 1)]
        v_l = _round_shift(a_l * (32 - shift_l) + b_l * shift_l, 5)

        v = np.where(use_above, v_a, v_l)
        return np.clip(v, 0, sample_max).astype(np.int32)


def luma_ac(
    luma_rec: np.ndarray,
    part_px: int,
    part_py: int,
    bsize,
    xdec: int,
    ydec: int,
    tx_size,
    frame_clipped_bw: int,
    frame_clipped_bh: int,
) -> np.ndarray:
    """CfL luma AC block: subsampled reconstructed luma, Q3, mean-removed
    (spec predict-chroma-from-luma; reference predict.rs:644-1063).

    ``luma_rec``: tile-origin padded luma view; ``part_px/part_py``: block
    origin in luma pixels.  Returns (plane_h, plane_w) int32.
    """
    plane_w = bsize.width >> xdec
    plane_h = bsize.height >> ydec

    # MaxLumaW/H: frame-clipped block size rounded up to tx multiples
    if bsize.width > 8:
        txw = tx_size.width
        max_luma_w = ((frame_clipped_bw + txw - 1) // txw) * txw
    else:
        max_luma_w = bsize.width
    if bsize.height > 8:
        txh = tx_size.height
        max_luma_h = ((frame_clipped_bh + txh - 1) // txh) * txh
    else:
        max_luma_h = bsize.height

    w_pad = (bsize.width - max_luma_w) >> (2 + xdec)
    h_pad = (bsize.height - max_luma_h) >> (2 + ydec)
    mlw = (plane_w - w_pad * 4) << xdec
    mlh = (plane_h - h_pad * 4) << ydec
    max_x = max(mlw, 8) - (1 << xdec)
    max_y = max(mlh, 8) - (1 << ydec)

    ys = np.minimum(np.arange(plane_h) << ydec, max_y) + part_py
    xs = np.minimum(np.arange(plane_w) << xdec, max_x) + part_px
    L = luma_rec.astype(np.int32)
    sample = L[ys[:, None], xs[None, :]]
    if xdec:
        sample = sample + L[ys[:, None], xs[None, :] + 1]
    if ydec:
        sample = sample + L[ys[:, None] + 1, xs[None, :]] + L[ys[:, None] + 1, xs[None, :] + 1]
    sample = sample << (3 - xdec - ydec)

    shift = plane_w.bit_length() - 1 + plane_h.bit_length() - 1
    average = (int(sample.sum()) + (1 << (shift - 1))) >> shift
    return (sample - average).astype(np.int32)
