"""Deblocking loop filter (normative; spec 7.14, reference src/deblock.rs).

Applied identically by encoder reconstruction and decoder.  AV1's design
makes every vertical edge independent of the others (filter reach never
crosses the next edge), and the horizontal pass depends only on the finished
vertical pass — so each pass vectorizes over all edges of a filter-size
class at once (the TPU-native formulation; reference applies per-edge
serially with a cache-friendly interleave, deblock.rs:1294-1466).

Level search: the reference's fast path (q-derived levels,
deblock.rs:1620-1652); the SSE tally search arrives with RDO work.
"""

from __future__ import annotations

import numpy as np

from encbench.reference.av1.context.writer import MAX_TXSIZE_RECT
from encbench.reference.av1.partition import MI_SIZE_LOG2, BlockSize
from encbench.reference.av1.tx import TxSize

MAX_LOOP_FILTER = 63


# --- level search ----------------------------------------------------------


def deblock_levels_fast(base_q_idx: int, bit_depth: int, is_key: bool, ac_quant: int):
    """q-derived filter levels (reference deblock_filter_optimize fast path)."""
    q = ac_quant
    if bit_depth == 8:
        if is_key:
            level = (q * 17563 - 421_574 + (1 << 17)) >> 18
        else:
            level = (q * 6017 + 650_707 + (1 << 17)) >> 18
    elif bit_depth == 10:
        level = (q * 20723 + 4_060_632 + (1 << 19)) >> 20
        if is_key:
            level -= 4
    else:
        level = (q * 20723 + 16_242_526 + (1 << 21)) >> 22
        if is_key:
            level -= 4
    level = min(max(level, 0), MAX_LOOP_FILTER)
    return [level, level, level, level]


# --- vectorized filter cores ----------------------------------------------
# All cores take (N, 4, taps) int32 pixel groups (4 lines per edge) and the
# scalar level/bd; they return the filtered group.  Orientation is handled by
# the caller via transposition.


def _clamp(v, lo, hi):
    return np.clip(v, lo, hi)


def _mask4(p1, p0, q0, q1, shift):
    limit_lvl = _ceil_shift(np.maximum(np.abs(p1 - p0), np.abs(q1 - q0)), shift)
    blimit = np.abs(p0 - q0) * 2 + np.abs(p1 - q1) // 2
    blimit_lvl = (_ceil_shift(blimit, shift) - 2) // 3
    return np.maximum(limit_lvl, blimit_lvl)


def _ceil_shift(v, shift):
    return (v + (1 << shift) - 1) >> shift


def _nhev4(p1, p0, q0, q1, shift):
    t = np.maximum(np.abs(p1 - p0), np.abs(q1 - q0))
    return (_ceil_shift(t, shift)) << 4


def _narrow_filters(p1, p0, q0, q1, shift, use4):
    lo, hi = -128 << shift, (128 << shift) - 1
    pix_hi = (256 << shift) - 1
    f0 = _clamp(p1 - q1, lo, hi)
    # narrow2 (uses f0), narrow4 (drops it)
    base2 = f0 + 3 * (q0 - p0)
    f1_2 = _clamp(base2 + 4, lo, hi) >> 3
    f2_2 = _clamp(base2 + 3, lo, hi) >> 3
    base4 = 3 * (q0 - p0)
    f1_4 = _clamp(base4 + 4, lo, hi) >> 3
    f2_4 = _clamp(base4 + 3, lo, hi) >> 3
    f3_4 = (f1_4 + 1) >> 1
    n2 = (
        p1,
        _clamp(p0 + f2_2, 0, pix_hi),
        _clamp(q0 - f1_2, 0, pix_hi),
        q1,
    )
    n4 = (
        _clamp(p1 + f3_4, 0, pix_hi),
        _clamp(p0 + f2_4, 0, pix_hi),
        _clamp(q0 - f1_4, 0, pix_hi),
        _clamp(q1 - f3_4, 0, pix_hi),
    )
    out = [np.where(use4, a4, a2) for a4, a2 in zip(n4, n2)]
    return out


def _deblock_group4(g, level, bd):
    p1, p0, q0, q1 = (g[..., i] for i in range(4))
    shift = bd - 8
    mask = _mask4(p1, p0, q0, q1, shift) <= level
    use4 = _nhev4(p1, p0, q0, q1, shift) <= level
    o = _narrow_filters(p1, p0, q0, q1, shift, use4)
    out = g.copy()
    for i, v in enumerate(o):
        out[..., i] = np.where(mask, v, g[..., i])
    return out


def _mask6(p2, p1, p0, q0, q1, q2, shift):
    m = np.maximum.reduce(
        [np.abs(p2 - p1), np.abs(p1 - p0), np.abs(q2 - q1), np.abs(q1 - q0)]
    )
    limit_lvl = _ceil_shift(m, shift)
    blimit = np.abs(p0 - q0) * 2 + np.abs(p1 - q1) // 2
    blimit_lvl = (_ceil_shift(blimit, shift) - 2) // 3
    return np.maximum(limit_lvl, blimit_lvl)


def _deblock_group6(g, level, bd):
    p2, p1, p0, q0, q1, q2 = (g[..., i] for i in range(6))
    shift = bd - 8
    flat_t = 1 << shift
    mask = _mask6(p2, p1, p0, q0, q1, q2, shift) <= level
    flat = (
        np.maximum.reduce(
            [np.abs(p1 - p0), np.abs(q1 - q0), np.abs(p2 - p0), np.abs(q2 - q0)]
        )
        <= flat_t
    )
    use4 = _nhev4(p1, p0, q0, q1, shift) <= level
    # wide6 (flat): 4 outputs at p1..q1
    w0 = (p2 * 3 + p1 * 2 + p0 * 2 + q0 + 4) >> 3
    w1 = (p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + 4) >> 3
    w2 = (p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + 4) >> 3
    w3 = (p0 + q0 * 2 + q1 * 2 + q2 * 3 + 4) >> 3
    narrow = _narrow_filters(p1, p0, q0, q1, shift, use4)
    out = g.copy()
    vals = [
        np.where(flat, w0, narrow[0]),
        np.where(flat, w1, narrow[1]),
        np.where(flat, w2, narrow[2]),
        np.where(flat, w3, narrow[3]),
    ]
    for i, v in enumerate(vals):
        out[..., 1 + i] = np.where(mask, v, g[..., 1 + i])
    return out


def _mask8(p3, p2, p1, p0, q0, q1, q2, q3, shift):
    m = np.maximum.reduce(
        [np.abs(p3 - p2), np.abs(p2 - p1), np.abs(p1 - p0),
         np.abs(q3 - q2), np.abs(q2 - q1), np.abs(q1 - q0)]
    )
    limit_lvl = _ceil_shift(m, shift)
    blimit = np.abs(p0 - q0) * 2 + np.abs(p1 - q1) // 2
    blimit_lvl = (_ceil_shift(blimit, shift) - 2) // 3
    return np.maximum(limit_lvl, blimit_lvl)


def _flat8(p3, p2, p1, p0, q0, q1, q2, q3):
    return np.maximum.reduce(
        [np.abs(p1 - p0), np.abs(q1 - q0), np.abs(p2 - p0),
         np.abs(q2 - q0), np.abs(p3 - p0), np.abs(q3 - q0)]
    )


def _wide8(p3, p2, p1, p0, q0, q1, q2, q3):
    return [
        (p3 * 3 + p2 * 2 + p1 + p0 + q0 + 4) >> 3,
        (p3 * 2 + p2 + p1 * 2 + p0 + q0 + q1 + 4) >> 3,
        (p3 + p2 + p1 + p0 * 2 + q0 + q1 + q2 + 4) >> 3,
        (p2 + p1 + p0 + q0 * 2 + q1 + q2 + q3 + 4) >> 3,
        (p1 + p0 + q0 + q1 * 2 + q2 + q3 * 2 + 4) >> 3,
        (p0 + q0 + q1 + q2 * 2 + q3 * 3 + 4) >> 3,
    ]


def _deblock_group8(g, level, bd):
    p3, p2, p1, p0, q0, q1, q2, q3 = (g[..., i] for i in range(8))
    shift = bd - 8
    flat_t = 1 << shift
    mask = _mask8(p3, p2, p1, p0, q0, q1, q2, q3, shift) <= level
    flat = _flat8(p3, p2, p1, p0, q0, q1, q2, q3) <= flat_t
    use4 = _nhev4(p1, p0, q0, q1, shift) <= level
    wide = _wide8(p3, p2, p1, p0, q0, q1, q2, q3)
    narrow = _narrow_filters(p1, p0, q0, q1, shift, use4)
    nar6 = [p2, narrow[0], narrow[1], narrow[2], narrow[3], q2]
    out = g.copy()
    for i in range(6):
        v = np.where(flat, wide[i], nar6[i])
        out[..., 1 + i] = np.where(mask, v, g[..., 1 + i])
    return out


def _deblock_group14(g, level, bd):
    cols = [g[..., i] for i in range(14)]
    p6, p5, p4, p3, p2, p1, p0, q0, q1, q2, q3, q4, q5, q6 = cols
    shift = bd - 8
    flat_t = 1 << shift
    mask = _mask8(p3, p2, p1, p0, q0, q1, q2, q3, shift) <= level
    flat_in = _flat8(p3, p2, p1, p0, q0, q1, q2, q3) <= flat_t
    flat_out = (
        np.maximum.reduce(
            [np.abs(p4 - p0), np.abs(q4 - q0), np.abs(p5 - p0),
             np.abs(q5 - q0), np.abs(p6 - p0), np.abs(q6 - q0)]
        )
        <= flat_t
    )
    use4 = _nhev4(p1, p0, q0, q1, shift) <= level
    w14 = [
        (p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0 + 8) >> 4,
        (p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0 + q0 + q1 + 8) >> 4,
        (p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0 + q0 + q1 + q2 + 8) >> 4,
        (p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0 + q0 + q1 + q2 + q3 + 8) >> 4,
        (p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2 + q0 + q1 + q2 + q3 + q4 + 8) >> 4,
        (p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + q2 + q3 + q4 + q5 + 8) >> 4,
        (p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + q3 + q4 + q5 + q6 + 8) >> 4,
        (p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 * 2 + q2 * 2 + q3 + q4 + q5 + q6 * 2 + 8) >> 4,
        (p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 * 2 + q3 * 2 + q4 + q5 + q6 * 3 + 8) >> 4,
        (p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 * 2 + q4 * 2 + q5 + q6 * 4 + 8) >> 4,
        (p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 * 2 + q5 * 2 + q6 * 5 + 8) >> 4,
        (p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 * 2 + q6 * 7 + 8) >> 4,
    ]
    w8_12 = _wide8(p3, p2, p1, p0, q0, q1, q2, q3)
    w8 = [p5, p4, p3] + w8_12[:6]
    # w8_12 positions: indices 3..8 of the 12-output window
    w8full = [p5, p4, p3, w8_12[0], w8_12[1], w8_12[2], w8_12[3], w8_12[4], w8_12[5], q3, q4, q5]
    narrow = _narrow_filters(p1, p0, q0, q1, shift, use4)
    nar12 = [p5, p4, p3, p2, narrow[0], narrow[1], narrow[2], narrow[3], q2, q3, q4, q5]
    out = g.copy()
    for i in range(12):
        v_flat = np.where(flat_out, w14[i], w8full[i])
        v = np.where(flat_in, v_flat, nar12[i])
        out[..., 1 + i] = np.where(mask, v, g[..., 1 + i])
    return out


_GROUP_FN = {4: _deblock_group4, 6: _deblock_group6, 8: _deblock_group8, 14: _deblock_group14}


# --- edge maps + frame driver ----------------------------------------------


def _plane_edge_decisions(blocks, pli, xdec, ydec, cols_p, rows_p, vertical):
    """filter_size per plane-4x4 position (0 = no filtering).

    Mirrors deblock_size (deblock.rs:95-131) vectorized over the grid.
    """
    # luma mi coordinates of each plane 4x4 unit
    jj, ii = np.mgrid[0:rows_p, 0:cols_p]
    ly = (jj << ydec) | ydec
    lx = (ii << xdec) | xdec
    ly = np.minimum(ly, blocks.rows - 1)
    lx = np.minimum(lx, blocks.cols - 1)

    bsize_g = blocks.bsize[ly, lx]
    if pli == 0:
        tx_g = blocks.tx_size[ly, lx]
        txw_mi = np.array([TxSize(t).width >> 2 for t in range(19)])[tx_g]
        txh_mi = np.array([TxSize(t).height >> 2 for t in range(19)])[tx_g]
    else:
        lut_w = np.zeros(22, dtype=np.int64)
        lut_h = np.zeros(22, dtype=np.int64)
        from encbench.reference.av1.encoder.pipeline import largest_chroma_tx_size

        for b in BlockSize:
            if b.width > 64 or b.height > 64:
                continue  # 128-wide blocks unused (64x64 superblocks)
            t = largest_chroma_tx_size(b, xdec, ydec)
            lut_w[int(b)] = t.width >> 2
            lut_h[int(b)] = t.height >> 2
        txw_mi = lut_w[bsize_g]
        txh_mi = lut_h[bsize_g]

    if vertical:
        prev_ly, prev_lx = ly, lx - (1 << xdec)
    else:
        prev_ly, prev_lx = ly - (1 << ydec), lx
    valid = (prev_lx >= 0) & (prev_ly >= 0)
    prev_lyc = np.maximum(prev_ly, 0)
    prev_lxc = np.maximum(prev_lx, 0)

    prev_bsize = blocks.bsize[prev_lyc, prev_lxc]
    if pli == 0:
        prev_tx = blocks.tx_size[prev_lyc, prev_lxc]
        ptxw = np.array([TxSize(t).width >> 2 for t in range(19)])[prev_tx]
        ptxh = np.array([TxSize(t).height >> 2 for t in range(19)])[prev_tx]
    else:
        ptxw = lut_w[prev_bsize]
        ptxh = lut_h[prev_bsize]

    # tx edge check in plane units
    if vertical:
        tx_edge = (ii & (txw_mi - 1)) == 0
        tx_n, ptx_n = txw_mi, ptxw
    else:
        tx_edge = (jj & (txh_mi - 1)) == 0
        tx_n, ptx_n = txh_mi, ptxh

    n4_w = np.array([BlockSize(b).width_mi for b in range(22)])[bsize_g]
    n4_h = np.array([BlockSize(b).height_mi for b in range(22)])[bsize_g]
    # block edges use the unadjusted (even) luma mi position (deblock.rs:1112)
    if vertical:
        block_edge = ((ii << xdec) & (n4_w - 1)) == 0
    else:
        block_edge = ((jj << ydec) & (n4_h - 1)) == 0

    skip_g = blocks.skip[ly, lx]
    pskip = blocks.skip[prev_lyc, prev_lxc]
    intra_g = blocks.ref_frames[ly, lx, 0] == 0
    pintra = blocks.ref_frames[prev_lyc, prev_lxc, 0] == 0

    apply = block_edge | ~skip_g | ~pskip | intra_g | pintra
    cap = 14 if pli == 0 else 6
    size = np.minimum(cap, np.minimum(tx_n, ptx_n) << MI_SIZE_LOG2)
    size = np.where(valid & tx_edge & apply, size, 0)
    return size


def _deblock_grid_arrays(blocks):
    """(ptrs, strides) int64 arrays for the native deblock grids + keepalives."""
    arrs = [blocks.bsize, blocks.tx_size,
            blocks.skip.view(np.uint8) if blocks.skip.dtype == bool else blocks.skip,
            blocks.ref_frames]
    ptrs = np.array([a.ctypes.data for a in arrs], dtype=np.int64)
    strides = np.array(
        [a.strides[0] // a.itemsize for a in arrs], dtype=np.int64
    )
    return ptrs, strides, arrs


def deblock_plane_native(levels, plane, blocks, pli, crop_w, crop_h, bd, xdec, ydec) -> bool:
    """Native whole-plane filter (native/tile_deblock.inc). Returns False
    when the library is unavailable (caller uses the numpy path)."""
    from encbench.reference.av1 import native

    lib = native.get_lib()
    if lib is None:
        return False
    ptrs, strides, keep = _deblock_grid_arrays(blocks)
    lv = np.asarray(levels, dtype=np.int32)
    pad = plane.cfg.pad
    data = plane.data
    lib.tile_deblock_plane(
        lv.ctypes.data,
        data.ctypes.data + (pad * data.strides[0] + pad * data.itemsize),
        data.strides[0] // data.itemsize, data.itemsize,
        ptrs.ctypes.data, strides.ctypes.data, blocks.rows, blocks.cols,
        pli, crop_w, crop_h, bd, xdec, ydec,
    )
    return True


def deblock_plane(levels, rec, blocks, pli, crop_w, crop_h, bd, xdec, ydec):
    """Filter one plane in place. ``rec`` is the plane-origin view."""
    if pli == 0:
        if levels[0] == 0 and levels[1] == 0:
            return
    elif levels[pli + 1] == 0:
        return

    # crop_w/crop_h are PLANE pixels: cover every plane 4x4 unit inside the
    # crop (capped by the luma mi grid).  The previous form decimated the
    # plane-unit count by xdec a second time, leaving the right/bottom half
    # of chroma planes unfiltered in both encoder and decoder (regression:
    # tests/test_device_dsp.py::test_deblock_chroma_full_coverage).
    cols_p = min((crop_w + 3) >> 2, (blocks.cols + xdec) >> xdec)
    rows_p = min((crop_h + 3) >> 2, (blocks.rows + ydec) >> ydec)

    for vertical in (True, False):
        level = levels[(0 if vertical else 1)] if pli == 0 else levels[pli + 1]
        if level == 0:
            continue
        sizes = _plane_edge_decisions(blocks, pli, xdec, ydec, cols_p, rows_p, vertical)
        if vertical:
            sizes[:, 0] = 0
        else:
            sizes[0, :] = 0
        for fsize in (4, 6, 8, 14):
            ej, ei = np.nonzero(sizes == fsize)
            if ej.size == 0:
                continue
            taps = fsize
            half = fsize >> 1
            if vertical:
                base_y = (ej << 2)[:, None, None] + np.arange(4)[None, :, None]
                base_x = ((ei << 2) - half)[:, None, None] + np.arange(taps)[None, None, :]
                g = rec[base_y, base_x].astype(np.int32)
                out = _GROUP_FN[fsize](g, level, bd)
                rec[base_y, base_x] = out.astype(rec.dtype)
            else:
                # broadcasting yields (N, 4, taps): axis 1 walks the 4 pixels
                # along the edge, axis 2 walks across it (p..q)
                base_y = ((ej << 2) - half)[:, None, None] + np.arange(taps)[None, None, :]
                base_x = (ei << 2)[:, None, None] + np.arange(4)[None, :, None]
                g = rec[base_y, base_x].astype(np.int32)
                out = _GROUP_FN[fsize](g, level, bd)
                rec[base_y, base_x] = out.astype(rec.dtype)


def deblock_filter_frame(levels, frame, blocks, crop_w, crop_h, bd, cs, luma_only=False) -> None:
    """Filter all planes of ``frame`` in place (frame-level mi ``blocks``)."""
    from encbench.reference.av1.config import ChromaSampling

    nplanes = 1 if (cs == ChromaSampling.Cs400 or luma_only) else 3
    for pli in range(nplanes):
        plane = frame.planes[pli]
        xd, yd = (0, 0) if pli == 0 else cs.decimation()
        pad = plane.cfg.pad
        pw = (crop_w + (1 << xd) - 1) >> xd
        ph = (crop_h + (1 << yd) - 1) >> yd
        if deblock_plane_native(levels, plane, blocks, pli, pw, ph, bd, xd, yd):
            continue
        rec = plane.data[pad:, pad:]
        deblock_plane(levels, rec, blocks, pli, pw, ph, bd, xd, yd)


def deblock_search_levels(
    fast_levels, rec_frame, src_frame, blocks, crop_w, crop_h, bd, cs,
):
    """SSE-driven level search around the q-derived fast levels
    (reference deblock_filter_optimize, deblock.rs:1620-1668).

    Filters luma on scratch copies for candidate levels and keeps the one
    minimizing SSE vs the source; chroma levels follow the luma choice.
    """
    import numpy as np

    base = fast_levels[0]
    pad = rec_frame.planes[0].cfg.pad

    from encbench.reference.av1 import native

    lib = native.get_lib()
    if lib is not None:
        ptrs, strides, keep = _deblock_grid_arrays(blocks)
        rp = rec_frame.planes[0]
        sp = src_frame.planes[0]
        best = lib.tile_deblock_search(
            base, rp.data.ctypes.data, rp.data.strides[0] // rp.data.itemsize,
            rp.data.itemsize, rp.cfg.pad, rp.cfg.alloc_width,
            rp.cfg.alloc_height, sp.data.ctypes.data,
            sp.data.strides[0] // sp.data.itemsize,
            ptrs.ctypes.data, strides.ctypes.data, blocks.rows, blocks.cols,
            crop_w, crop_h, bd,
        )
        return _with_luma_level(fast_levels, best)

    src = src_frame.planes[0].data[pad:, pad:][:crop_h, :crop_w].astype(np.int64)

    candidates = sorted({max(0, min(base + d, 63)) for d in (-4, -2, 0, 2, 4)})
    best_lv, best_sse = None, None
    for lv in candidates:
        work = _luma_scratch(rec_frame)
        deblock_filter_frame(
            [lv, lv, fast_levels[2], fast_levels[3]], work, blocks,
            crop_w, crop_h, bd, cs, luma_only=True,
        )
        wl = work.planes[0].data[pad:, pad:][:crop_h, :crop_w].astype(np.int64)
        sse = int(((wl - src) ** 2).sum())
        if best_sse is None or sse < best_sse:
            best_lv, best_sse = lv, sse
    return _with_luma_level(fast_levels, best_lv)


def _with_luma_level(fast_levels, best):
    """Combine the searched luma level with the fast chroma levels.

    When both luma levels are 0 the frame header omits the chroma levels
    entirely (spec 5.9.11 loop_filter_params), so the decoder sees chroma
    level 0 — the encoder must then not filter chroma either."""
    if best == 0:
        return [0, 0, 0, 0]
    return [best, best, fast_levels[2], fast_levels[3]]


def _luma_scratch(frame):
    """Shallow frame clone with a private luma plane copy."""
    import copy as _copy

    work = _copy.copy(frame)
    work.planes = list(frame.planes)
    p0 = _copy.copy(frame.planes[0])
    p0.data = frame.planes[0].data.copy()
    work.planes[0] = p0
    return work
