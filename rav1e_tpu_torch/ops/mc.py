"""Motion compensation: 8-tap subpel interpolation (normative).

Counterpart of the reference's ``src/mc.rs`` (``put_8tap``, filter tables at
mc.rs:110-216 — normative constants from the AV1 spec's Subpel_Filters).
Vectorized over whole blocks; batches over candidate MVs during search.
"""

from __future__ import annotations

import numpy as np

# AV1 spec subpel filter sets (Q7):
# [REGULAR, SMOOTH, SHARP, BILINEAR, REGULAR4, SMOOTH4]
SUBPEL_FILTERS = np.array([
    [
        [0, 0, 0, 128, 0, 0, 0, 0], [0, 2, -6, 126, 8, -2, 0, 0],
        [0, 2, -10, 122, 18, -4, 0, 0], [0, 2, -12, 116, 28, -8, 2, 0],
        [0, 2, -14, 110, 38, -10, 2, 0], [0, 2, -14, 102, 48, -12, 2, 0],
        [0, 2, -16, 94, 58, -12, 2, 0], [0, 2, -14, 84, 66, -12, 2, 0],
        [0, 2, -14, 76, 76, -14, 2, 0], [0, 2, -12, 66, 84, -14, 2, 0],
        [0, 2, -12, 58, 94, -16, 2, 0], [0, 2, -12, 48, 102, -14, 2, 0],
        [0, 2, -10, 38, 110, -14, 2, 0], [0, 2, -8, 28, 116, -12, 2, 0],
        [0, 0, -4, 18, 122, -10, 2, 0], [0, 0, -2, 8, 126, -6, 2, 0],
    ],
    [
        [0, 0, 0, 128, 0, 0, 0, 0], [0, 2, 28, 62, 34, 2, 0, 0],
        [0, 0, 26, 62, 36, 4, 0, 0], [0, 0, 22, 62, 40, 4, 0, 0],
        [0, 0, 20, 60, 42, 6, 0, 0], [0, 0, 18, 58, 44, 8, 0, 0],
        [0, 0, 16, 56, 46, 10, 0, 0], [0, -2, 16, 54, 48, 12, 0, 0],
        [0, -2, 14, 52, 52, 14, -2, 0], [0, 0, 12, 48, 54, 16, -2, 0],
        [0, 0, 10, 46, 56, 16, 0, 0], [0, 0, 8, 44, 58, 18, 0, 0],
        [0, 0, 6, 42, 60, 20, 0, 0], [0, 0, 4, 40, 62, 22, 0, 0],
        [0, 0, 4, 36, 62, 26, 0, 0], [0, 0, 2, 34, 62, 28, 2, 0],
    ],
    [
        [0, 0, 0, 128, 0, 0, 0, 0], [-2, 2, -6, 126, 8, -2, 2, 0],
        [-2, 6, -12, 124, 16, -6, 4, -2], [-2, 8, -18, 120, 26, -10, 6, -2],
        [-4, 10, -22, 116, 38, -14, 6, -2], [-4, 10, -22, 108, 48, -18, 8, -2],
        [-4, 10, -24, 100, 60, -20, 8, -2], [-4, 10, -24, 90, 70, -22, 10, -2],
        [-4, 12, -24, 80, 80, -24, 12, -4], [-2, 10, -22, 70, 90, -24, 10, -4],
        [-2, 8, -20, 60, 100, -24, 10, -4], [-2, 8, -18, 48, 108, -22, 10, -4],
        [-2, 6, -14, 38, 116, -22, 10, -4], [-2, 6, -10, 26, 120, -18, 8, -2],
        [-2, 4, -6, 16, 124, -12, 6, -2], [0, 2, -2, 8, 126, -6, 2, -2],
    ],
    [
        [0, 0, 0, 128, 0, 0, 0, 0], [0, 0, 0, 120, 8, 0, 0, 0],
        [0, 0, 0, 112, 16, 0, 0, 0], [0, 0, 0, 104, 24, 0, 0, 0],
        [0, 0, 0, 96, 32, 0, 0, 0], [0, 0, 0, 88, 40, 0, 0, 0],
        [0, 0, 0, 80, 48, 0, 0, 0], [0, 0, 0, 72, 56, 0, 0, 0],
        [0, 0, 0, 64, 64, 0, 0, 0], [0, 0, 0, 56, 72, 0, 0, 0],
        [0, 0, 0, 48, 80, 0, 0, 0], [0, 0, 0, 40, 88, 0, 0, 0],
        [0, 0, 0, 32, 96, 0, 0, 0], [0, 0, 0, 24, 104, 0, 0, 0],
        [0, 0, 0, 16, 112, 0, 0, 0], [0, 0, 0, 8, 120, 0, 0, 0],
    ],
    [
        [0, 0, 0, 128, 0, 0, 0, 0], [0, 0, -4, 126, 8, -2, 0, 0],
        [0, 0, -8, 122, 18, -4, 0, 0], [0, 0, -10, 116, 28, -6, 0, 0],
        [0, 0, -12, 110, 38, -8, 0, 0], [0, 0, -12, 102, 48, -10, 0, 0],
        [0, 0, -14, 94, 58, -10, 0, 0], [0, 0, -12, 84, 66, -10, 0, 0],
        [0, 0, -12, 76, 76, -12, 0, 0], [0, 0, -10, 66, 84, -12, 0, 0],
        [0, 0, -10, 58, 94, -14, 0, 0], [0, 0, -10, 48, 102, -12, 0, 0],
        [0, 0, -8, 38, 110, -12, 0, 0], [0, 0, -6, 28, 116, -10, 0, 0],
        [0, 0, -4, 18, 122, -8, 0, 0], [0, 0, -2, 8, 126, -4, 0, 0],
    ],
    [
        [0, 0, 0, 128, 0, 0, 0, 0], [0, 0, 30, 62, 34, 2, 0, 0],
        [0, 0, 26, 62, 36, 4, 0, 0], [0, 0, 22, 62, 40, 4, 0, 0],
        [0, 0, 20, 60, 42, 6, 0, 0], [0, 0, 18, 58, 44, 8, 0, 0],
        [0, 0, 16, 56, 46, 10, 0, 0], [0, 0, 14, 54, 48, 12, 0, 0],
        [0, 0, 12, 52, 52, 12, 0, 0], [0, 0, 12, 48, 54, 14, 0, 0],
        [0, 0, 10, 46, 56, 16, 0, 0], [0, 0, 8, 44, 58, 18, 0, 0],
        [0, 0, 6, 42, 60, 20, 0, 0], [0, 0, 4, 40, 62, 22, 0, 0],
        [0, 0, 4, 36, 62, 26, 0, 0], [0, 0, 2, 34, 62, 30, 0, 0],
    ],
], dtype=np.int32)

REGULAR, SMOOTH, SHARP, BILINEAR = 0, 1, 2, 3


def _get_filter(mode: int, frac: int, length: int) -> np.ndarray:
    idx = mode if (mode == BILINEAR or length > 4) else min(mode, 1) + 4
    return SUBPEL_FILTERS[idx][frac]


def _round_shift(x, bit):
    return (x + (1 << (bit - 1))) >> bit


def mv_to_offsets(mv_row: int, mv_col: int, xdec: int, ydec: int):
    """Split a 1/8-pel luma MV into this plane's integer offset + 1/16-frac
    (reference predict.rs get_mv_params)."""
    row_int = mv_row >> (3 + ydec)
    col_int = mv_col >> (3 + xdec)
    row_frac = (mv_row << (1 - ydec)) & 0xF
    col_frac = (mv_col << (1 - xdec)) & 0xF
    return row_int, col_int, row_frac, col_frac


def put_8tap(
    ref: np.ndarray,
    x0: int,
    y0: int,
    w: int,
    h: int,
    col_frac: int,  # 1/16-pel fraction (0..15)
    row_frac: int,
    mode_x: int,
    mode_y: int,
    bd: int,
) -> np.ndarray:
    """Motion-compensated prediction of a (h, w) block at integer position
    (x0, y0) with 16-phase subpel fractions.

    ``ref`` is the padded reference plane indexable at negative offsets
    (callers pass views with sufficient border).
    Exact integer pipeline per mc.rs:250-355.
    """
    from rav1e_tpu_torch import native

    lib = native.get_lib()
    if lib is not None and ref.ndim == 2 and ref.itemsize in (1, 2):
        out = np.empty((h, w), dtype=np.int32)
        lib.enc_put_8tap(
            ref.ctypes.data, ref.strides[0] // ref.itemsize, ref.itemsize,
            x0, y0, w, h, col_frac, row_frac, mode_x, mode_y, bd,
            out.ctypes.data,
        )
        return out

    max_val = (1 << bd) - 1
    inter_bits = 4 - (2 if bd == 12 else 0)

    if col_frac == 0 and row_frac == 0:
        return ref[y0 : y0 + h, x0 : x0 + w].astype(np.int32)

    xf = _get_filter(mode_x, col_frac, w)
    yf = _get_filter(mode_y, row_frac, h)

    if col_frac == 0:
        src = ref[y0 - 3 : y0 + h + 4, x0 : x0 + w].astype(np.int64)
        acc = np.zeros((h, w), dtype=np.int64)
        for k in range(8):
            acc += yf[k] * src[k : k + h]
        return np.clip(_round_shift(acc, 7), 0, max_val).astype(np.int32)
    if row_frac == 0:
        src = ref[y0 : y0 + h, x0 - 3 : x0 + w + 4].astype(np.int64)
        acc = np.zeros((h, w), dtype=np.int64)
        for k in range(8):
            acc += xf[k] * src[:, k : k + w]
        out = _round_shift(_round_shift(acc, 7 - inter_bits), inter_bits)
        return np.clip(out, 0, max_val).astype(np.int32)

    src = ref[y0 - 3 : y0 + h + 4, x0 - 3 : x0 + w + 4].astype(np.int64)
    horiz = np.zeros((h + 7, w), dtype=np.int64)
    for k in range(8):
        horiz += xf[k] * src[:, k : k + w]
    horiz = _round_shift(horiz, 7 - inter_bits)
    # intermediate is i16 in the reference; clamp-wrap equivalently
    horiz = ((horiz + (1 << 15)) & 0xFFFF) - (1 << 15)
    acc = np.zeros((h, w), dtype=np.int64)
    for k in range(8):
        acc += yf[k] * horiz[k : k + h]
    out = _round_shift(acc, 7 + inter_bits)
    return np.clip(out, 0, max_val).astype(np.int32)


PREP_BIAS = 8192  # mc.rs:357 (keeps the compound intermediate in i16)


def prep_8tap(
    ref: np.ndarray,
    x0: int,
    y0: int,
    w: int,
    h: int,
    col_frac: int,
    row_frac: int,
    mode_x: int,
    mode_y: int,
    bd: int,
) -> np.ndarray:
    """Compound-prediction intermediate: like :func:`put_8tap` but keeping
    ``intermediate_bits`` extra precision and no final clamp
    (reference mc.rs:360-452).  Returns int32 (h, w) in the i16 domain.
    """
    inter_bits = 4 - (2 if bd == 12 else 0)
    prep_bias = 0 if bd == 8 else PREP_BIAS

    xf = _get_filter(mode_x, col_frac, w)
    yf = _get_filter(mode_y, row_frac, h)

    if col_frac == 0 and row_frac == 0:
        t = (ref[y0 : y0 + h, x0 : x0 + w].astype(np.int64) << inter_bits) - prep_bias
        return t.astype(np.int32)
    if col_frac == 0:
        src = ref[y0 - 3 : y0 + h + 4, x0 : x0 + w].astype(np.int64)
        acc = np.zeros((h, w), dtype=np.int64)
        for k in range(8):
            acc += yf[k] * src[k : k + h]
        return (_round_shift(acc, 7 - inter_bits) - prep_bias).astype(np.int32)
    if row_frac == 0:
        src = ref[y0 : y0 + h, x0 - 3 : x0 + w + 4].astype(np.int64)
        acc = np.zeros((h, w), dtype=np.int64)
        for k in range(8):
            acc += xf[k] * src[:, k : k + w]
        return (_round_shift(acc, 7 - inter_bits) - prep_bias).astype(np.int32)

    src = ref[y0 - 3 : y0 + h + 4, x0 - 3 : x0 + w + 4].astype(np.int64)
    horiz = np.zeros((h + 7, w), dtype=np.int64)
    for k in range(8):
        horiz += xf[k] * src[:, k : k + w]
    horiz = _round_shift(horiz, 7 - inter_bits)
    # intermediate is i16 in the reference
    horiz = ((horiz + (1 << 15)) & 0xFFFF) - (1 << 15)
    acc = np.zeros((h, w), dtype=np.int64)
    for k in range(8):
        acc += yf[k] * horiz[k : k + h]
    return (_round_shift(acc, 7) - prep_bias).astype(np.int32)


def mc_avg(tmp1: np.ndarray, tmp2: np.ndarray, bd: int) -> np.ndarray:
    """Compound average of two prep_8tap intermediates (mc.rs:454-480)."""
    inter_bits = 4 - (2 if bd == 12 else 0)
    prep_bias = 0 if bd == 8 else PREP_BIAS * 2
    v = _round_shift(
        tmp1.astype(np.int64) + tmp2.astype(np.int64) + prep_bias, inter_bits + 1
    )
    return np.clip(v, 0, (1 << bd) - 1).astype(np.int32)
