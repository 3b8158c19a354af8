"""Loop restoration filters (LRF): Wiener and self-guided (SgrProj).

Capability counterpart of the reference's ``src/lrf.rs``.  Normative
filtering is vectorized over whole stripes (box sums via 2D prefix sums
feeding elementwise integer math — a natural TPU/XLA shape), while the
encoder-side solve accumulates the 2x2 normal equations per restoration
unit in one pass over the same intermediate arrays.

Stripe semantics (lrf.rs:1485-1580): luma stripes are 64 rows offset by
-8 (first stripe = 56 rows); 4:2:0 chroma stripes are halved.  Inside a
stripe the filter reads the CDEF output; the two rows above/below come
from the pre-CDEF (deblocked) frame, clamped to 2 rows beyond the stripe
(lrf.rs:402-468).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

RESTORE_NONE = 0
RESTORE_SWITCHABLE = 1
RESTORE_WIENER = 2
RESTORE_SGRPROJ = 3

WIENER_TAPS_MIN = [-5, -23, -17]
WIENER_TAPS_MID = [3, -7, 15]
WIENER_TAPS_MAX = [10, 8, 46]

SGRPROJ_XQD_MIN = [-96, -32]
SGRPROJ_XQD_MID = [-32, 31]
SGRPROJ_XQD_MAX = [31, 95]
SGRPROJ_PRJ_SUBEXP_K = 4
SGRPROJ_PRJ_BITS = 7
SGRPROJ_PARAMS_BITS = 4
SGRPROJ_MTABLE_BITS = 20
SGRPROJ_SGR_BITS = 8
SGRPROJ_RECIP_BITS = 12
SGRPROJ_RST_BITS = 4

# (s_r2, s_r1) per parameter set (lrf.rs:56-73)
SGRPROJ_PARAMS_S = [
    [140, 3236], [112, 2158], [93, 1618], [80, 1438],
    [70, 1295], [58, 1177], [47, 1079], [37, 996],
    [30, 925], [25, 863], [0, 2589], [0, 1618],
    [0, 1177], [0, 925], [56, 0], [22, 0],
]

SGRPROJ_REDUCED_SETS = [1, 3, 5, 7, 9, 11, 13, 15]
SGRPROJ_FAST_SETS = [3, 7, 11, 15]  # fast presets: half the solve cost
SGRPROJ_ALL_SETS = list(range(16))


# ---------------------------------------------------------------------------
# Restoration state (unit grid per plane; lrf.rs:1210-1483)
# ---------------------------------------------------------------------------

# a filter is a tuple: ("none",) | ("wiener", ((a,b,c),(d,e,f))) | ("sgr", set, (xqd0, xqd1))
FILTER_NONE = ("none",)


@dataclass
class RestorationPlaneCfg:
    lrf_type: int
    unit_size: int
    sb_h_shift: int
    sb_v_shift: int
    sb_cols: int
    sb_rows: int
    stripe_height: int
    cols: int
    rows: int


class RestorationPlane:
    def __init__(self, cfg: RestorationPlaneCfg):
        self.cfg = cfg
        self.units: List[List[tuple]] = [
            [FILTER_NONE for _ in range(cfg.cols)] for _ in range(cfg.rows)
        ]

    def unit_index(self, sb_x: int, sb_y: int, stretch: bool) -> Optional[Tuple[int, int]]:
        """LRU (x, y) a superblock belongs to (tile_restoration_state.rs:196-218)."""
        cfg = self.cfg
        if cfg.rows <= 0 or cfg.cols <= 0:
            return None
        x_stretch = sb_x < cfg.sb_cols and (sb_x >> cfg.sb_h_shift) >= cfg.cols
        y_stretch = sb_y < cfg.sb_rows and (sb_y >> cfg.sb_v_shift) >= cfg.rows
        if (x_stretch or y_stretch) and not stretch:
            return None
        x = (sb_x >> cfg.sb_h_shift) - (1 if x_stretch else 0)
        y = (sb_y >> cfg.sb_v_shift) - (1 if y_stretch else 0)
        if x < cfg.cols and y < cfg.rows:
            return (x, y)
        return None

    def unit_by_stripe(self, stripenum: int, rux: int) -> tuple:
        """(lrf.rs:1295-1313): stripes are assigned to LRU rows by luma position."""
        cfg = self.cfg
        x = min(rux, cfg.cols - 1)
        y = min(stripenum * cfg.stripe_height // cfg.unit_size, cfg.rows - 1)
        return self.units[y][x]


class RestorationState:
    """Per-frame LRF configuration + unit grid for all planes."""

    def __init__(self, planes: List[RestorationPlane]):
        self.planes = planes

    @classmethod
    def build(
        cls, width: int, height: int, cs, base_q_idx: int, sb_width: int,
        sb_height: int, unit_sizes: Optional[Tuple[int, int]] = None,
        lrf_types: Tuple[int, int, int] = (RESTORE_SWITCHABLE,) * 3,
    ) -> "RestorationState":
        """Unit-size selection per lrf.rs:1321-1446 (q-driven when not given
        explicitly; decoder passes header-parsed sizes)."""
        from rav1e_tpu_torch.config import ChromaSampling

        xdec, ydec = (0, 0) if cs == ChromaSampling.Cs400 else cs.decimation()
        stripe_uv_decimate = 1 if (xdec > 0 and ydec > 0) else 0
        y_sb_log2 = 6
        uv_sb_h_log2 = y_sb_log2 - xdec
        uv_sb_v_log2 = y_sb_log2 - ydec

        if unit_sizes is not None:
            y_unit_size, uv_unit_size = unit_sizes
        else:
            if base_q_idx > 200:
                base_shift = 0
            elif base_q_idx > 160:
                base_shift = 1
            else:
                base_shift = 2
            chroma_shift = 0
            if stripe_uv_decimate:
                if base_shift == 2:
                    chroma_shift = 1
                else:
                    us = 1 << (8 - base_shift)
                    unshifted = ((width >> xdec) - 1) % us <= us // 2 or (
                        (height >> ydec) - 1
                    ) % us <= us // 2
                    shifted = ((width >> xdec) - 1) % (us >> 1) <= us // 4 or (
                        (height >> ydec) - 1
                    ) % (us >> 1) <= us // 4
                    chroma_shift = int(unshifted and not shifted)
            y_unit_size = 1 << (8 - base_shift)
            uv_unit_size = 1 << (8 - base_shift - chroma_shift)
            if ydec == 0 and y_unit_size != uv_unit_size:
                y_unit_size = uv_unit_size = min(y_unit_size, uv_unit_size)

        y_cols = max((width + (y_unit_size >> 1)) // y_unit_size, 1)
        y_rows = max((height + (y_unit_size >> 1)) // y_unit_size, 1)
        uv_w = (width + (1 << xdec >> 1)) >> xdec
        uv_h = (height + (1 << ydec >> 1)) >> ydec
        uv_cols = max((uv_w + (uv_unit_size >> 1)) // uv_unit_size, 1)
        uv_rows = max((uv_h + (uv_unit_size >> 1)) // uv_unit_size, 1)

        y_log2 = y_unit_size.bit_length() - 1
        uv_log2 = uv_unit_size.bit_length() - 1
        planes = [
            RestorationPlane(RestorationPlaneCfg(
                lrf_types[0], y_unit_size, y_log2 - y_sb_log2, y_log2 - y_sb_log2,
                sb_width, sb_height, 64, y_cols, y_rows,
            )),
            RestorationPlane(RestorationPlaneCfg(
                lrf_types[1], uv_unit_size, uv_log2 - uv_sb_h_log2,
                uv_log2 - uv_sb_v_log2, sb_width, sb_height,
                32 if stripe_uv_decimate else 64, uv_cols, uv_rows,
            )),
            RestorationPlane(RestorationPlaneCfg(
                lrf_types[2], uv_unit_size, uv_log2 - uv_sb_h_log2,
                uv_log2 - uv_sb_v_log2, sb_width, sb_height,
                32 if stripe_uv_decimate else 64, uv_cols, uv_rows,
            )),
        ]
        return cls(planes)

    def any_filters(self) -> bool:
        return any(
            u != FILTER_NONE for rp in self.planes for row in rp.units for u in row
        )


# ---------------------------------------------------------------------------
# SgrProj core (lrf.rs:176-345, spec 7.17.3)
# ---------------------------------------------------------------------------


def _stripe_source(cdef_arr, debl_arr, px, sy, ncols, nrows, row0, col0,
                   stripe_h, crop_w, crop_h):
    """Gather the vertically/horizontally padded stripe source
    (VertPaddedIter/HorzPaddedIter, lrf.rs:387-527): rows inside the stripe
    come from the CDEF output, rows outside from the deblocked frame clamped
    2 rows past the stripe; both clamp to the visible frame."""
    yy = np.arange(nrows) + sy + row0
    cropped = np.clip(yy, 0, crop_h - 1)
    ly = np.clip(cropped, sy - 2, sy + stripe_h + 1)
    use_cdef = (ly >= sy) & (ly < sy + stripe_h)
    xx = np.clip(np.arange(ncols) + px + col0, 0, crop_w - 1)
    rows_c = cdef_arr[ly][:, xx]
    rows_d = debl_arr[ly][:, xx]
    return np.where(use_cdef[:, None], rows_c, rows_d).astype(np.int64)


def _sum_finish(ssq, ssum, n, one_over_n, s, bd):
    bdm8 = bd - 8
    scaled_ssq = (ssq + (1 << (2 * bdm8) >> 1)) >> (2 * bdm8) if bdm8 else ssq
    scaled_sum = (ssum + (1 << bdm8 >> 1)) >> bdm8 if bdm8 else ssum
    p = np.maximum(scaled_ssq * n - scaled_sum * scaled_sum, 0)
    z = (p * s + (1 << SGRPROJ_MTABLE_BITS >> 1)) >> SGRPROJ_MTABLE_BITS
    a = np.where(
        z >= 255, 256,
        np.where(z == 0, 1, ((z << SGRPROJ_SGR_BITS) + z // 2) // np.maximum(z + 1, 1)),
    )
    b = ((1 << SGRPROJ_SGR_BITS) - a) * ssum * one_over_n
    return a, (b + (1 << SGRPROJ_RECIP_BITS >> 1)) >> SGRPROJ_RECIP_BITS


def _boxes(P, Psq, ys, d, n, one_over_n, s, ncols, bd):
    """A,B rows for box diameter d at integral rows ``ys``, cols 0..ncols-1."""
    ys = np.asarray(ys)[:, None]
    xs = np.arange(ncols)[None, :]

    def box(M):
        return M[ys + d, xs + d] - M[ys, xs + d] - M[ys + d, xs] + M[ys, xs]

    return _sum_finish(box(Psq), box(P), n, one_over_n, s, bd)


def sgr_stripe_geom(cdef_arr, debl_arr, px, sy, uw, sh, crop_w, crop_h):
    """Set-independent stripe precomputation: padded source, integral
    images, and raw box sums.  Shared across all candidate s-parameters in
    the encoder's per-unit search (the s-dependent half lives in
    :func:`sgr_compute_f_from_geom`)."""
    sh_even = sh + (sh & 1)
    nrows = 4 + sh_even + 2
    # the integral-image source treats the stripe as even-height (the
    # reference's VertPaddedIter receives stripe_h + (stripe_h & 1),
    # lrf.rs:558-561), so for odd sh the row at sy+sh still reads CDEF
    S = _stripe_source(cdef_arr, debl_arr, px, sy, uw + 7, nrows, -4, -4,
                       sh_even, crop_w, crop_h)
    P = S.cumsum(axis=0).cumsum(axis=1)
    Psq = (S * S).cumsum(axis=0).cumsum(axis=1)
    lines = _stripe_source(cdef_arr, debl_arr, px, sy, uw, sh, 0, 0, sh,
                           crop_w, crop_h)  # pure cdef rows (inside stripe)
    return {"P": P, "Psq": Psq, "lines": lines, "sh": sh, "uw": uw}


def _geom_boxsums(g, which):
    """Raw (ssq, sum) box sums for the r2 (d=5, even rows) or r1 (d=3)
    window, memoized on the geom dict."""
    key = "bs" + which
    if key not in g:
        P, Psq, sh, uw = g["P"], g["Psq"], g["sh"], g["uw"]
        if which == "2":
            ys = np.arange(0, sh + 2, 2)[:, None]
            d = 5
        else:
            P, Psq = P[:, 1:], Psq[:, 1:]
            ys = (np.arange(0, sh + 2) + 1)[:, None]
            d = 3
        xs = np.arange(uw + 2)[None, :]

        def box(M):
            return M[ys + d, xs + d] - M[ys, xs + d] - M[ys + d, xs] + M[ys, xs]

        g[key] = (box(Psq), box(P))
    return g[key]


def sgr_compute_f(cdef_arr, debl_arr, px, sy, uw, sh, crop_w, crop_h, bd,
                  s_r2, s_r1):
    """f2/f1 arrays (sh, uw) for one stripe of one unit
    (sgrproj_stripe_filter, lrf.rs:630-830)."""
    g = sgr_stripe_geom(cdef_arr, debl_arr, px, sy, uw, sh, crop_w, crop_h)
    f2, f1 = sgr_compute_f_from_geom(g, bd, s_r2, s_r1)
    return f2, f1, g["lines"]


def sgr_compute_f_from_geom(g, bd, s_r2, s_r1):
    sh, uw, lines = g["sh"], g["uw"], g["lines"]

    if s_r2 > 0:
        ssq2, sum2 = _geom_boxsums(g, "2")
        A2, B2 = _sum_finish(ssq2, sum2, 25, 164, s_r2, bd)
        a2c = 5 * (A2[:, :-2] + A2[:, 2:]) + 6 * A2[:, 1:-1]
        b2c = 5 * (B2[:, :-2] + B2[:, 2:]) + 6 * B2[:, 1:-1]
        shift, shifto = 9, 8
        n_even = (sh + 1) // 2
        j0 = np.arange(n_even)
        even_rows = lines[0:sh:2]
        f2 = np.zeros((sh, uw), dtype=np.int64)
        f2[0:sh:2] = (
            (a2c[j0] + a2c[j0 + 1]) * even_rows + b2c[j0] + b2c[j0 + 1]
            + (1 << shift >> 1)
        ) >> shift
        if sh > 1:
            n_odd = sh // 2
            j1 = np.arange(n_odd) + 1
            odd_rows = lines[1:sh:2]
            f2[1:sh:2] = (a2c[j1] * odd_rows + b2c[j1] + (1 << shifto >> 1)) >> shifto
    else:
        # r2 disabled: the reference computes f_r2 only for the even row of
        # each pair and shares it with the odd row ("share results for both
        # rows", lrf.rs:746-750) — odd rows use the row above's pixels
        f2 = np.repeat(lines[0:sh:2] << SGRPROJ_RST_BITS, 2, axis=0)[:sh]

    if s_r1 > 0:
        ssq1, sum1 = _geom_boxsums(g, "1")
        A1, B1 = _sum_finish(ssq1, sum1, 9, 455, s_r1, bd)
        T = [A1[:-2], A1[1:-1], A1[2:]]
        U = [B1[:-2], B1[1:-1], B1[2:]]
        a1c = 3 * (T[0][:, :-2] + T[2][:, :-2] + T[0][:, 2:] + T[2][:, 2:]) + 4 * (
            T[1][:, :-2] + T[0][:, 1:-1] + T[1][:, 1:-1] + T[2][:, 1:-1] + T[1][:, 2:]
        )
        b1c = 3 * (U[0][:, :-2] + U[2][:, :-2] + U[0][:, 2:] + U[2][:, 2:]) + 4 * (
            U[1][:, :-2] + U[0][:, 1:-1] + U[1][:, 1:-1] + U[2][:, 1:-1] + U[1][:, 2:]
        )
        f1 = (a1c[:sh] * lines + b1c[:sh] + (1 << 9 >> 1)) >> 9
    else:
        f1 = lines << SGRPROJ_RST_BITS

    return f2, f1


def sgr_apply(f2, f1, lines, xqd, bd):
    w0 = int(xqd[0])
    w1 = int(xqd[1])
    w2 = (1 << SGRPROJ_PRJ_BITS) - w0 - w1
    u = lines.astype(np.int64) << SGRPROJ_RST_BITS
    v = w0 * f2.astype(np.int64) + w1 * u + w2 * f1.astype(np.int64)
    shift = SGRPROJ_RST_BITS + SGRPROJ_PRJ_BITS
    s = (v + (1 << shift >> 1)) >> shift
    return np.clip(s, 0, (1 << bd) - 1)


def sgr_solve_accumulate(f2, f1, lines, src, acc):
    """Accumulate normal equations for the xqd solve (sgrproj_solve,
    lrf.rs:997-1046). ``acc`` = [h00, h01, h11, c0, c1, n]."""
    u = lines.astype(np.int64) << SGRPROJ_RST_BITS
    s = (src.astype(np.int64) << SGRPROJ_RST_BITS) - u
    d2 = f2.astype(np.int64) - u
    d1 = f1.astype(np.int64) - u
    acc[0] += int((d2 * d2).sum())
    acc[1] += int((d1 * d2).sum())
    acc[2] += int((d1 * d1).sum())
    acc[3] += int((d2 * s).sum())
    acc[4] += int((d1 * s).sum())
    acc[5] += s.size


def sgr_solve_finish(acc, sgr_set) -> Tuple[int, int]:
    """Solve 2x2 for xqd and clamp (lrf.rs:1052-1097)."""
    s_r2, s_r1 = SGRPROJ_PARAMS_S[sgr_set]
    n = float(max(acc[5], 1))
    h00 = acc[0] / n
    h01 = acc[1] / n
    h11 = acc[2] / n
    c0 = acc[3] * (1 << SGRPROJ_PRJ_BITS) / n
    c1 = acc[4] * (1 << SGRPROJ_PRJ_BITS) / n
    if s_r2 == 0:
        xq0, xq1 = 0, (0 if h11 == 0.0 else round(c1 / h11))
    elif s_r1 == 0:
        xq0, xq1 = (0 if h00 == 0.0 else round(c0 / h00)), 0
    else:
        det = h00 * h11 - h01 * h01
        if det == 0.0:
            xq0, xq1 = 0, 0
        else:
            xq0 = round((h11 * c0 - h01 * c1) / det)
            xq1 = round((h00 * c1 - h01 * c0) / det)
    xqd0 = max(SGRPROJ_XQD_MIN[0], min(int(xq0), SGRPROJ_XQD_MAX[0]))
    xqd1 = max(
        SGRPROJ_XQD_MIN[1],
        min((1 << SGRPROJ_PRJ_BITS) - xqd0 - int(xq1), SGRPROJ_XQD_MAX[1]),
    )
    return xqd0, xqd1


# ---------------------------------------------------------------------------
# Wiener core (wiener_stripe_filter, lrf.rs:1099-1207)
# ---------------------------------------------------------------------------


def wiener_filter_stripe(coeffs, cdef_arr, debl_arr, out_arr, px, sy, uw, sh,
                         crop_w, crop_h, bd):
    round_h = 5 if bd == 12 else 3
    round_v = 9 if bd == 12 else 11
    offset = 1 << (bd + 7 - round_h - 1)
    limit = (1 << (bd + 1 + 7 - round_h)) - 1

    def taps7(c):
        c = [int(v) for v in c]
        return np.array(
            [c[0], c[1], c[2], 128 - 2 * (c[0] + c[1] + c[2]), c[2], c[1], c[0]],
            dtype=np.int64,
        )

    vf = taps7(coeffs[0])
    hf = taps7(coeffs[1])

    # vertical source rows sy-3 .. sy+sh+3 with the wiener selection rule
    yy = np.arange(sh + 7) + sy - 3
    above = yy < sy
    below = yy >= sy + sh
    ly = np.clip(yy, 0, crop_h - 1)
    ly = np.where(above, np.maximum(ly, sy - 2), ly)
    ly = np.where(below, np.minimum(ly, sy + sh + 1), ly)
    use_cdef = ~(above | below)
    xx = np.clip(np.arange(uw + 6) + px - 3, 0, crop_w - 1)
    R = np.where(use_cdef[:, None], cdef_arr[ly][:, xx], debl_arr[ly][:, xx]).astype(np.int64)

    H = np.zeros((sh + 7, uw), dtype=np.int64)
    for i in range(7):
        H += hf[i] * R[:, i : i + uw]
    work = np.clip((H + (1 << round_h >> 1)) >> round_h, -offset, limit - offset)

    V = np.zeros((sh, uw), dtype=np.int64)
    for i in range(7):
        V += vf[i] * work[i : i + sh]
    out = np.clip((V + (1 << round_v >> 1)) >> round_v, 0, (1 << bd) - 1)
    out_arr[sy : sy + sh, px : px + uw] = out.astype(out_arr.dtype)


# ---------------------------------------------------------------------------
# Frame driver (lrf_filter_frame, lrf.rs:1485-1583)
# ---------------------------------------------------------------------------


def _plane_stripes(si, ydec, crop_h):
    if si == 0:
        return 0, (64 - 8) >> ydec
    start = (si * 64 - 8) >> ydec
    return start, min(64 >> ydec, crop_h - start)


def lrf_filter_frame(rs: RestorationState, frame, deblocked_planes, width,
                     height, bd, cs) -> None:
    """Apply restoration in place on ``frame`` (the CDEF output).
    ``deblocked_planes``: list of pre-CDEF plane arrays (visible-origin views).
    """
    from rav1e_tpu_torch.config import ChromaSampling

    nplanes = 1 if cs == ChromaSampling.Cs400 else 3
    stripe_n = (height + 7) // 64 + 1
    for pli in range(nplanes):
        rp = rs.planes[pli]
        if rp.cfg.lrf_type == RESTORE_NONE:
            continue
        plane = frame.planes[pli]
        xdec, ydec = plane.cfg.xdec, plane.cfg.ydec
        crop_w = (width + (1 << xdec >> 1)) >> xdec
        crop_h = (height + (1 << ydec >> 1)) >> ydec
        pad = plane.cfg.pad
        out_arr = plane.data[pad:, pad:]
        cdef_arr = out_arr.copy()
        debl_arr = deblocked_planes[pli]

        from rav1e_tpu_torch import native as _native

        lib = _native.get_lib()
        use_native = (
            lib is not None
            and cdef_arr.itemsize in (1, 2)
            and cdef_arr.strides[1] == cdef_arr.itemsize
            and debl_arr.strides[1] == debl_arr.itemsize
        )
        for si in range(stripe_n):
            sy, sh = _plane_stripes(si, ydec, crop_h)
            if sh <= 0 or sy >= crop_h:
                continue
            for rux in range(rp.cfg.cols):
                x = rux * rp.cfg.unit_size
                uw = crop_w - x if rux == rp.cfg.cols - 1 else rp.cfg.unit_size
                filt = rp.unit_by_stripe(si, rux)
                if filt[0] == "wiener":
                    if use_native:
                        c6 = np.ascontiguousarray(
                            np.asarray(filt[1], dtype=np.int32).reshape(-1)
                        )
                        lib.enc_wiener_apply_stripe(
                            c6.ctypes.data,
                            cdef_arr.ctypes.data,
                            cdef_arr.strides[0] // cdef_arr.itemsize,
                            debl_arr.ctypes.data,
                            debl_arr.strides[0] // debl_arr.itemsize,
                            cdef_arr.itemsize,
                            out_arr.ctypes.data,
                            out_arr.strides[0] // out_arr.itemsize,
                            x, sy, uw, sh, crop_w, crop_h, bd,
                        )
                        continue
                    wiener_filter_stripe(
                        filt[1], cdef_arr, debl_arr, out_arr, x, sy, uw, sh,
                        crop_w, crop_h, bd,
                    )
                elif filt[0] == "sgr":
                    s_r2, s_r1 = SGRPROJ_PARAMS_S[filt[1]]
                    if use_native:
                        lib.enc_sgr_apply_stripe(
                            cdef_arr.ctypes.data,
                            cdef_arr.strides[0] // cdef_arr.itemsize,
                            debl_arr.ctypes.data,
                            debl_arr.strides[0] // debl_arr.itemsize,
                            cdef_arr.itemsize,
                            out_arr.ctypes.data,
                            out_arr.strides[0] // out_arr.itemsize,
                            x, sy, uw, sh, crop_w, crop_h, bd,
                            int(s_r2), int(s_r1),
                            int(filt[2][0]), int(filt[2][1]),
                        )
                        continue
                    g = sgr_stripe_geom(
                        cdef_arr, debl_arr, x, sy, uw, sh, crop_w, crop_h
                    )
                    f2, f1 = sgr_compute_f_from_geom(g, bd, s_r2, s_r1)
                    out = sgr_apply(f2, f1, g["lines"], filt[2], bd)
                    out_arr[sy : sy + sh, x : x + uw] = out.astype(out_arr.dtype)


# ---------------------------------------------------------------------------
# Encoder-side per-unit decision (solve + SSE compare)
# ---------------------------------------------------------------------------


def _sgr_decide_native(cdef_arr, debl_arr, src_arr, x, uw, pieces, crop_w,
                       crop_h, bd, sets):
    """Whole-unit SgrProj decision in C (native/lrf.cc); returns
    [(xqd0, xqd1, sse)] per set, or None to use the numpy path."""
    from rav1e_tpu_torch import native

    lib = native.get_lib()
    if lib is None or cdef_arr.itemsize not in (1, 2):
        return None
    if cdef_arr.strides[1] != cdef_arr.itemsize or \
       debl_arr.strides[1] != debl_arr.itemsize or \
       src_arr.strides[1] != src_arr.itemsize:
        return None
    stripes = np.ascontiguousarray(
        np.array([[sy, sh] for sy, sh in pieces], dtype=np.int64).reshape(-1)
    )
    params = np.ascontiguousarray(
        np.array([SGRPROJ_PARAMS_S[s] for s in sets], dtype=np.int64).reshape(-1)
    )
    out = np.zeros(3 * len(sets), dtype=np.int64)
    lib.enc_sgr_decide_unit(
        cdef_arr.ctypes.data, cdef_arr.strides[0] // cdef_arr.itemsize,
        debl_arr.ctypes.data, debl_arr.strides[0] // debl_arr.itemsize,
        src_arr.ctypes.data, src_arr.strides[0] // src_arr.itemsize,
        cdef_arr.itemsize, x, uw,
        stripes.ctypes.data, len(pieces), crop_w, crop_h, bd,
        params.ctypes.data, len(sets), out.ctypes.data,
    )
    return [tuple(out[3 * i : 3 * i + 3]) for i in range(len(sets))]


def lrf_decide_units(rs: RestorationState, frame, deblocked_planes, source,
                     width, height, bd, cs, sets=SGRPROJ_REDUCED_SETS) -> None:
    """Per-LRU filter selection: solve SgrProj xqd for each candidate set on
    the unit's stripe-quantized region, pick min SSE vs the source (including
    the no-filter option).  Counterpart of the reference's LRU RDO
    (rdo.rs sgrproj path); rate cost enters with full RDO later."""
    from rav1e_tpu_torch.config import ChromaSampling

    nplanes = 1 if cs == ChromaSampling.Cs400 else 3
    stripe_n = (height + 7) // 64 + 1
    for pli in range(nplanes):
        rp = rs.planes[pli]
        if rp.cfg.lrf_type == RESTORE_NONE:
            continue
        plane = frame.planes[pli]
        xdec, ydec = plane.cfg.xdec, plane.cfg.ydec
        crop_w = (width + (1 << xdec >> 1)) >> xdec
        crop_h = (height + (1 << ydec >> 1)) >> ydec
        pad = plane.cfg.pad
        cdef_arr = plane.data[pad:, pad:]
        debl_arr = deblocked_planes[pli]
        spad = source.planes[pli].cfg.pad
        src_arr = source.planes[pli].data[spad:, spad:]

        # stripe list per unit row (stripe-quantized unit regions)
        unit_stripes: List[List[int]] = [[] for _ in range(rp.cfg.rows)]
        flat_stripes: List[int] = []
        stripe_urow: List[int] = []
        for si in range(stripe_n):
            sy, sh = _plane_stripes(si, ydec, crop_h)
            if sh <= 0 or sy >= crop_h:
                continue
            uy = min(si * rp.cfg.stripe_height // rp.cfg.unit_size, rp.cfg.rows - 1)
            unit_stripes[uy].append(si)
            flat_stripes += [sy, sh]
            stripe_urow.append(uy)

        from rav1e_tpu_torch import native as _native

        lib = _native.get_lib()
        if (
            lib is not None
            and cdef_arr.itemsize in (1, 2)
            and cdef_arr.strides[1] == cdef_arr.itemsize
            and debl_arr.strides[1] == debl_arr.itemsize
            and src_arr.strides[1] == src_arr.itemsize
        ):
            # one native call decides every unit of the plane
            st = np.ascontiguousarray(np.array(flat_stripes, dtype=np.int64))
            ur = np.ascontiguousarray(np.array(stripe_urow, dtype=np.int32))
            pr = np.ascontiguousarray(
                np.array([SGRPROJ_PARAMS_S[ss] for ss in sets], dtype=np.int64)
                .reshape(-1)
            )
            rows, cols = rp.cfg.rows, rp.cfg.cols
            out = np.zeros(rows * cols * len(sets) * 3, dtype=np.int64)
            out_none = np.zeros(rows * cols, dtype=np.int64)
            lib.enc_sgr_decide_plane(
                cdef_arr.ctypes.data, cdef_arr.strides[0] // cdef_arr.itemsize,
                debl_arr.ctypes.data, debl_arr.strides[0] // debl_arr.itemsize,
                src_arr.ctypes.data, src_arr.strides[0] // src_arr.itemsize,
                cdef_arr.itemsize, crop_w, crop_h, bd,
                st.ctypes.data, ur.ctypes.data, len(stripe_urow),
                rp.cfg.unit_size, rows, cols, pr.ctypes.data, len(sets),
                out.ctypes.data, out_none.ctypes.data,
            )
            out = out.reshape(rows, cols, len(sets), 3)
            out_none = out_none.reshape(rows, cols)
            for uy in range(rows):
                for ux in range(cols):
                    best = FILTER_NONE
                    best_sse = int(out_none[uy, ux])
                    for k, sgr_set in enumerate(sets):
                        sse = int(out[uy, ux, k, 2])
                        if sse < best_sse:
                            best_sse = sse
                            best = ("sgr", sgr_set,
                                    (int(out[uy, ux, k, 0]), int(out[uy, ux, k, 1])))
                    rp.units[uy][ux] = best
            continue

        for uy in range(rp.cfg.rows):
            for ux in range(rp.cfg.cols):
                x = ux * rp.cfg.unit_size
                uw = crop_w - x if ux == rp.cfg.cols - 1 else rp.cfg.unit_size
                best = (FILTER_NONE, None)
                sse_none = 0
                pieces = []  # (sy, sh, f2/f1/lines per set computed lazily)
                for si in unit_stripes[uy]:
                    sy, sh = _plane_stripes(si, ydec, crop_h)
                    sse_none += int(
                        ((cdef_arr[sy : sy + sh, x : x + uw].astype(np.int64)
                          - src_arr[sy : sy + sh, x : x + uw]) ** 2).sum()
                    )
                    pieces.append((sy, sh))
                best_sse = sse_none
                native_out = _sgr_decide_native(
                    cdef_arr, debl_arr, src_arr, x, uw, pieces, crop_w,
                    crop_h, bd, sets,
                )
                if native_out is not None:
                    for sgr_set, (xqd0, xqd1, sse) in zip(sets, native_out):
                        if sse < best_sse:
                            best_sse = sse
                            best = (("sgr", sgr_set, (int(xqd0), int(xqd1))), None)
                    rp.units[uy][ux] = best[0]
                    continue
                geoms = [
                    (
                        sgr_stripe_geom(
                            cdef_arr, debl_arr, x, sy, uw, sh, crop_w, crop_h
                        ),
                        src_arr[sy : sy + sh, x : x + uw],
                    )
                    for sy, sh in pieces
                ]
                for sgr_set in sets:
                    s_r2, s_r1 = SGRPROJ_PARAMS_S[sgr_set]
                    acc = [0, 0, 0, 0, 0, 0]
                    cached = []
                    for g, src in geoms:
                        f2, f1 = sgr_compute_f_from_geom(g, bd, s_r2, s_r1)
                        lines = g["lines"]
                        sgr_solve_accumulate(f2, f1, lines, src, acc)
                        cached.append((f2, f1, lines, src))
                    xqd = sgr_solve_finish(acc, sgr_set)
                    sse = 0
                    for f2, f1, lines, src in cached:
                        out = sgr_apply(f2, f1, lines, xqd, bd)
                        sse += int(((out - src) ** 2).sum())
                    if sse < best_sse:
                        best_sse = sse
                        best = (("sgr", sgr_set, xqd), None)
                rp.units[uy][ux] = best[0]


# ---------------------------------------------------------------------------
# Bitstream signaling shared by ContextWriter / ContextReader
# (context/frame_header.rs:171-270, spec 5.11.57 read_lr_unit)
# ---------------------------------------------------------------------------


class TileRestorationRefs:
    """Per-tile predictor state for LRF params."""

    def __init__(self, nplanes=3):
        self.wiener_ref = [[list(WIENER_TAPS_MID), list(WIENER_TAPS_MID)]
                           for _ in range(nplanes)]
        self.sgrproj_ref = [list(SGRPROJ_XQD_MID) for _ in range(nplanes)]
        self.last_coded = [-1] * nplanes
