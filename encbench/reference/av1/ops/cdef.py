"""CDEF: constrained directional enhancement filter (normative; spec 7.15,
reference src/cdef.rs).

Both encoder and decoder run identical code: direction estimation from the
deblocked reconstruction, then the 2-primary/4-secondary tap filter per 8x8
(luma) block.  TPU-first shape: direction search is 8 one-hot matmuls over
all blocks at once (MXU), and the filter evaluates as gathered window
tensors (N, h+4, w+4) with per-block direction indices — no per-pixel
control flow.
"""

from __future__ import annotations

import functools

import numpy as np

CDEF_VERY_LARGE = 0x8000
CDEF_SEC_STRENGTHS = 4

# (dy, dx) per direction and tap distance (cdef.rs:242-251 / spec 7.15.3)
CDEF_DIRECTIONS = np.array(
    [
        [[-1, 1], [-2, 2]],
        [[0, 1], [-1, 2]],
        [[0, 1], [0, 2]],
        [[0, 1], [1, 2]],
        [[1, 1], [2, 2]],
        [[1, 0], [2, 1]],
        [[1, 0], [2, 0]],
        [[1, 0], [2, -1]],
    ],
    dtype=np.int64,
)

CDEF_UV_DIR_422 = np.array([7, 0, 2, 4, 5, 6, 6, 6], dtype=np.int64)

_DIV_TABLE = np.array([0, 840, 420, 280, 210, 168, 140, 120, 105], dtype=np.int64)


@functools.lru_cache(None)
def _partial_matrices():
    """One-hot (64, 15) matrices mapping pixel (i, j) -> partial-sum bucket
    per direction (cdef.rs:97-104)."""
    mats = np.zeros((8, 64, 15), dtype=np.int64)
    for i in range(8):
        for j in range(8):
            px = i * 8 + j
            mats[0, px, i + j] = 1
            mats[1, px, i + j // 2] = 1
            mats[2, px, i] = 1
            mats[3, px, 3 + i - j // 2] = 1
            mats[4, px, 7 + i - j] = 1
            mats[5, px, 3 - i // 2 + j] = 1
            mats[6, px, j] = 1
            mats[7, px, i // 2 + j] = 1
    return mats


def cdef_find_dirs(luma8: np.ndarray, bd: int):
    """Directions + variances for a batch of 8x8 luma blocks.

    luma8: (N, 8, 8) int. Returns (dir (N,), var (N,)).
    """
    shift = bd - 8
    x = (luma8.astype(np.int64) >> shift) - 128
    flat = x.reshape(-1, 64)
    mats = _partial_matrices()
    partial = np.einsum("npk,bn->bpk", mats.transpose(1, 0, 2), flat)  # (B,8,15)

    cost = np.zeros((flat.shape[0], 8), dtype=np.int64)
    # directions 2 and 6: 8 equal-length lines
    for d in (2, 6):
        cost[:, d] = (partial[:, d, :8] ** 2).sum(axis=1) * _DIV_TABLE[8]
    # directions 0 and 4: diagonal lines of varying length
    for d in (0, 4):
        p = partial[:, d]
        c = np.zeros(flat.shape[0], dtype=np.int64)
        for i in range(7):
            c += (p[:, i] ** 2 + p[:, 14 - i] ** 2) * _DIV_TABLE[i + 1]
        c += p[:, 7] ** 2 * _DIV_TABLE[8]
        cost[:, d] = c
    # odd directions
    for d in (1, 3, 5, 7):
        p = partial[:, d]
        c = (p[:, 3:8] ** 2).sum(axis=1) * _DIV_TABLE[8]
        for j in range(3):
            c += (p[:, j] ** 2 + p[:, 10 - j] ** 2) * _DIV_TABLE[2 * j + 2]
        cost[:, d] = c

    best_dir = np.argmax(cost, axis=1)  # ties -> first (argmax does that)
    best_cost = np.take_along_axis(cost, best_dir[:, None], 1)[:, 0]
    ortho = np.take_along_axis(cost, ((best_dir + 4) & 7)[:, None], 1)[:, 0]
    var = (best_cost - ortho) >> 10
    return best_dir.astype(np.int64), var.astype(np.int64)


def _constrain(diff, threshold: int, damping: int):
    if threshold == 0:
        return np.zeros_like(diff)
    shift = max(0, damping - (threshold.bit_length() - 1))
    mag = np.clip(threshold - (np.abs(diff) >> shift), 0, np.abs(diff))
    return np.where(diff < 0, -mag, mag)


def _adjust_strength(strength: int, var: np.ndarray):
    i = np.where(var >> 6 != 0, np.minimum(_msb_arr(var >> 6), 12), 0)
    return np.where(var != 0, (strength * (4 + i) + 8) >> 4, 0)


def _msb_arr(v):
    out = np.zeros_like(v)
    vv = v.copy()
    while np.any(vv > 1):
        m = vv > 1
        out[m] += 1
        vv[m] >>= 1
    return out


def cdef_filter_blocks(
    windows: np.ndarray,  # (N, ys+4, xs+4) int32; missing ring = CDEF_VERY_LARGE
    dirs: np.ndarray,  # (N,)
    pri_strength,  # (N,) or scalar (luma is var-adjusted per block)
    sec_strength: int,
    damping: int,
    bd: int,
):
    """Filter a batch of blocks; returns (N, ys, xs) int32."""
    n, wh, ww = windows.shape
    ys, xs = wh - 4, ww - 4
    x = windows[:, 2 : 2 + ys, 2 : 2 + xs].astype(np.int64)
    coeff_shift = bd - 8
    pri = np.broadcast_to(np.asarray(pri_strength, dtype=np.int64), (n,))
    # tap sets switch on bit 0 of the unscaled primary strength
    pri_bit = (pri >> coeff_shift) & 1
    pri_taps = np.where(pri_bit[:, None] == 0, [[4, 2]], [[3, 3]])  # (N,2)
    sec_taps = np.array([2, 1], dtype=np.int64)

    total = np.zeros_like(x)
    mx = x.copy()
    mn = x.copy()

    dir_sets = [dirs, (dirs + 2) & 7, (dirs + 6) & 7]
    for k in range(2):
        for which, dset in enumerate(dir_sets):
            dy = CDEF_DIRECTIONS[dset, k, 0][:, None, None]
            dx = CDEF_DIRECTIONS[dset, k, 1][:, None, None]
            for sgn in (1, -1):
                iy = 2 + sgn * dy + np.arange(ys)[None, :, None]
                ix = 2 + sgn * dx + np.arange(xs)[None, None, :]
                p = windows[np.arange(n)[:, None, None], iy, ix].astype(np.int64)
                diff = p - x
                if which == 0:
                    # primary taps: per-block strength
                    thr = pri[:, None, None]
                    shift = np.maximum(0, damping - _msb_arr(np.maximum(pri, 1))[:, None, None])
                    mag = np.clip(thr - (np.abs(diff) >> shift), 0, np.abs(diff))
                    con = np.where(diff < 0, -mag, mag)
                    con = np.where(thr == 0, 0, con)
                    total += pri_taps[:, k][:, None, None] * con
                else:
                    con = _constrain(diff, sec_strength, damping)
                    total += sec_taps[k] * con
                valid = p != CDEF_VERY_LARGE
                mx = np.where(valid, np.maximum(p, mx), mx)
                mn = np.minimum(p, mn)

    v = x + ((8 + total - (total < 0)) >> 4)
    return np.clip(v, mn, mx).astype(np.int32)


def cdef_strengths_fast(ac_quant: int):
    """Heuristic strength selection from the quantizer (RDO search later)."""
    pri = min(ac_quant >> 6, 15)
    sec = 1 if ac_quant > 60 else 0
    y = pri * CDEF_SEC_STRENGTHS + sec
    uv = max(pri >> 1, 0) * CDEF_SEC_STRENGTHS + sec
    return y, uv


def cdef_frame_state(frame, blocks, bd: int, crop_w: int, crop_h: int,
                     cdef_idx_map=None):
    """Precompute the filtered-8x8 list, directions/variances and edge
    availability once per frame (shared by the RDO candidates and the final
    apply — the expensive half of cdef_filter_frame)."""
    mi_cols, mi_rows = blocks.cols, blocks.rows
    nbx = (mi_cols + 1) // 2
    nby = (mi_rows + 1) // 2
    skip = blocks.skip
    sk = np.ones((nby * 2, nbx * 2), dtype=bool)
    sk[:mi_rows, :mi_cols] = skip
    sk8 = sk.reshape(nby, 2, nbx, 2).all(axis=(1, 3))
    filt = ~sk8
    sb_idx8 = None
    if cdef_idx_map is not None:
        sb_idx8 = cdef_idx_map[
            np.minimum(np.arange(nby) // 8, cdef_idx_map.shape[0] - 1)[:, None],
            np.minimum(np.arange(nbx) // 8, cdef_idx_map.shape[1] - 1)[None, :],
        ]
        filt &= sb_idx8 >= 0
    by, bx = np.nonzero(filt)
    if by.size == 0:
        return None
    blk_idx = (
        sb_idx8[by, bx].astype(np.int64)
        if cdef_idx_map is not None
        else np.zeros(by.size, dtype=np.int64)
    )

    from encbench.reference.av1 import native

    lib = native.get_lib()
    luma = frame.planes[0]
    pad = luma.cfg.pad
    larr = luma.data[pad:, pad:]
    if lib is not None and larr.itemsize in (1, 2):
        by32 = np.ascontiguousarray(by, dtype=np.int32)
        bx32 = np.ascontiguousarray(bx, dtype=np.int32)
        dirs = np.empty(len(by), dtype=np.int32)
        variances = np.empty(len(by), dtype=np.int32)
        lib.enc_cdef_dirs(
            larr.ctypes.data, larr.strides[0] // larr.itemsize, larr.itemsize,
            len(by), by32.ctypes.data, bx32.ctypes.data, bd,
            dirs.ctypes.data, variances.ctypes.data,
        )
        dirs = dirs.astype(np.int64)
        variances = variances.astype(np.int64)
    else:
        win_idx_y = (by * 8)[:, None, None] + np.arange(8)[None, :, None]
        win_idx_x = (bx * 8)[:, None, None] + np.arange(8)[None, None, :]
        dirs, variances = cdef_find_dirs(larr[win_idx_y, win_idx_x], bd)

    return {
        "by": by, "bx": bx, "blk_idx": blk_idx,
        "dirs": dirs, "variances": variances,
        "have_top": by > 0, "have_left": bx > 0,
        "have_right": (bx + 2) * 8 <= crop_w,
        "have_bottom": (by + 2) * 8 <= crop_h,
    }


def cdef_filter_frame(
    fh_params, frame, blocks, bd: int, cs, crop_w: int, crop_h: int,
    cdef_idx_map=None, state=None,
) -> None:
    """Apply CDEF in place over the whole frame.

    ``fh_params``: (damping, y_strength, uv_strength) for single-strength
    (cdef_bits == 0) operation, or (damping, y_strengths, uv_strengths)
    lists with a per-64x64 ``cdef_idx_map`` (sb_rows, sb_cols) int array;
    SBs with index < 0 are left unfiltered (never-coded cdef_idx).
    """
    from encbench.reference.av1.config import ChromaSampling

    damping, y_str, uv_str = fh_params
    if cdef_idx_map is None:
        y_list = [y_str]
        uv_list = [uv_str]
    else:
        y_list = list(y_str)
        uv_list = list(uv_str)
    if all(v == 0 for v in y_list) and all(v == 0 for v in uv_list):
        return
    coeff_shift = bd - 8

    def unpack(v):
        pri = v // CDEF_SEC_STRENGTHS
        sec = v % CDEF_SEC_STRENGTHS
        sec += int(sec == 3)
        return pri, sec

    if state is None:
        state = cdef_frame_state(frame, blocks, bd, crop_w, crop_h, cdef_idx_map)
    if state is None:
        return
    by, bx, blk_idx = state["by"], state["bx"], state["blk_idx"]
    if cdef_idx_map is not None:
        # a shared state may have been built before the idx map existed
        blk_idx = cdef_idx_map[
            np.minimum(by // 8, cdef_idx_map.shape[0] - 1),
            np.minimum(bx // 8, cdef_idx_map.shape[1] - 1),
        ].astype(np.int64)
        keepm = blk_idx >= 0
        if not keepm.all():
            by, bx, blk_idx = by[keepm], bx[keepm], blk_idx[keepm]
            state = dict(state)
            for k in ("dirs", "variances", "have_top", "have_left",
                      "have_right", "have_bottom"):
                state[k] = state[k][keepm]
    dirs, variances = state["dirs"], state["variances"]
    have_top, have_left = state["have_top"], state["have_left"]
    have_right, have_bottom = state["have_right"], state["have_bottom"]

    pri_y_arr = np.array([unpack(v)[0] for v in y_list], dtype=np.int64)[blk_idx]
    sec_y_arr = np.array([unpack(v)[1] for v in y_list], dtype=np.int64)[blk_idx]
    pri_uv_arr = np.array([unpack(v)[0] for v in uv_list], dtype=np.int64)[blk_idx]
    sec_uv_arr = np.array([unpack(v)[1] for v in uv_list], dtype=np.int64)[blk_idx]

    from encbench.reference.av1 import native

    lib = native.get_lib()
    nplanes = 1 if cs == ChromaSampling.Cs400 else 3
    for p in range(nplanes):
        plane = frame.planes[p]
        xd, yd = (0, 0) if p == 0 else cs.decimation()
        xs, ys = 8 >> xd, 8 >> yd
        ppad = plane.cfg.pad
        parr = plane.data[ppad:, ppad:]
        pre = parr.copy()  # all reads from the pre-CDEF copy

        if p == 0:
            pri = _adjust_strength(pri_y_arr << coeff_shift, variances)
            pri = np.where(pri_y_arr != 0, pri, 0)
            ldirs = np.where(pri_y_arr != 0, dirs, 0)
            sec_arr = sec_y_arr << coeff_shift
            damp = damping + coeff_shift
        else:
            pri = pri_uv_arr << coeff_shift
            if xd != yd:
                ldirs = CDEF_UV_DIR_422[dirs]
            else:
                ldirs = dirs
            ldirs = np.where(pri_uv_arr != 0, ldirs, 0)
            sec_arr = sec_uv_arr << coeff_shift
            damp = damping + coeff_shift - 1

        # group by secondary strength (the filter cores take a scalar sec)
        for sec in np.unique(sec_arr):
            sel = sec_arr == sec
            gby, gbx = by[sel], bx[sel]
            gpri, gdirs = pri[sel], ldirs[sel]
            g_ht, g_hl = have_top[sel], have_left[sel]
            g_hr, g_hb = have_right[sel], have_bottom[sel]
            if int(sec) == 0 and np.all(gpri == 0):
                continue
            if lib is not None and parr.itemsize in (1, 2):
                # keep the ctypes-passed arrays alive in locals for the call
                by32 = np.ascontiguousarray(gby, dtype=np.int32)
                bx32 = np.ascontiguousarray(gbx, dtype=np.int32)
                dirs32 = np.ascontiguousarray(gdirs, dtype=np.int32)
                pri32 = np.ascontiguousarray(gpri, dtype=np.int32)
                ht = np.ascontiguousarray(g_ht, dtype=np.uint8)
                hl = np.ascontiguousarray(g_hl, dtype=np.uint8)
                hr = np.ascontiguousarray(g_hr, dtype=np.uint8)
                hb = np.ascontiguousarray(g_hb, dtype=np.uint8)
                lib.enc_cdef_filter(
                    pre.ctypes.data, pre.shape[1], pre.itemsize,
                    parr.ctypes.data, parr.strides[0] // parr.itemsize,
                    len(gby), by32.ctypes.data, bx32.ctypes.data,
                    dirs32.ctypes.data, pri32.ctypes.data,
                    int(sec), damp, bd, xs, ys,
                    ht.ctypes.data, hl.ctypes.data, hr.ctypes.data, hb.ctypes.data,
                )
                continue

            wy = (gby * ys - 2)[:, None, None] + np.arange(ys + 4)[None, :, None]
            wx = (gbx * xs - 2)[:, None, None] + np.arange(xs + 4)[None, None, :]
            windows = pre[wy, wx].astype(np.int32)
            # missing rings -> VERY_LARGE
            ring = CDEF_VERY_LARGE
            windows[~g_ht, :2, :] = ring
            windows[~g_hl, :, :2] = ring
            windows[~g_hr, :, -2:] = ring
            windows[~g_hb, -2:, :] = ring

            out = cdef_filter_blocks(windows, gdirs, gpri, int(sec), damp, bd)
            oy = (gby * ys)[:, None, None] + np.arange(ys)[None, :, None]
            ox = (gbx * xs)[:, None, None] + np.arange(xs)[None, None, :]
            parr[oy, ox] = out.astype(parr.dtype)


def _frame_scratch(frame):
    """Clone with private plane data (for candidate filtering)."""
    import copy as _copy

    work = _copy.copy(frame)
    work.planes = []
    for p in frame.planes:
        q = _copy.copy(p)
        q.data = p.data.copy()
        work.planes.append(q)
    return work


def cdef_rdo_frame(
    rec_frame, src_frame, blocks, bd: int, cs, crop_w: int, crop_h: int,
    damping: int, base_y: int, base_uv: int,
):
    """Per-64x64 CDEF strength selection (counterpart of the reference's
    rdo_loop_decision CDEF axis, rdo.rs:2104): evaluate a 4-entry strength
    preset over the whole frame, pick the per-SB SSE argmin.

    Returns (y_strengths[4], uv_strengths[4], idx_map) with idx_map shaped
    (sb_rows, sb_cols); SBs where no candidate beats "off" get index 0 with
    strength 0 in slot 0.
    """
    pri = base_y // CDEF_SEC_STRENGTHS
    sec = base_y % CDEF_SEC_STRENGTHS
    y_strengths = [0, base_y, max(pri // 2, 1) * CDEF_SEC_STRENGTHS + sec,
                   min(pri * 2 + 1, 15) * CDEF_SEC_STRENGTHS + sec]
    pri_uv = base_uv // CDEF_SEC_STRENGTHS
    sec_uv = base_uv % CDEF_SEC_STRENGTHS
    uv_strengths = [0, base_uv, max(pri_uv // 2, 0) * CDEF_SEC_STRENGTHS + sec_uv,
                    min(pri_uv * 2 + 1, 15) * CDEF_SEC_STRENGTHS + sec_uv]

    sb_rows = (crop_h + 63) // 64
    sb_cols = (crop_w + 63) // 64

    # the filtered-block set, directions and availability are
    # candidate-independent — compute once and share across the 4 trials
    # and the final apply (the caller passes idx_map back in)
    state = cdef_frame_state(rec_frame, blocks, bd, crop_w, crop_h)
    if state is None:  # every 8x8 is skip: nothing to filter
        return y_strengths, uv_strengths, np.zeros((sb_rows, sb_cols), np.int32), None
    by, bx = state["by"], state["bx"]
    sb_of_block = (np.minimum(by // 8, sb_rows - 1) * sb_cols
                   + np.minimum(bx // 8, sb_cols - 1))

    def filtered_block_sse(frame_obj):
        """Per-SB SSE over the filtered 8x8 blocks only (unfiltered pixels
        contribute the same constant to every candidate)."""
        total = np.zeros(sb_rows * sb_cols, dtype=np.int64)
        from encbench.reference.av1.config import ChromaSampling

        nplanes = 1 if cs == ChromaSampling.Cs400 else 3
        for p in range(nplanes):
            plane = frame_obj.planes[p]
            xd, yd = plane.cfg.xdec, plane.cfg.ydec
            pad = plane.cfg.pad
            pw = (crop_w + (1 << xd) - 1) >> xd
            ph = (crop_h + (1 << yd) - 1) >> yd
            rec = plane.data[pad:, pad:]
            src = src_frame.planes[p].data[pad:, pad:]
            xs, ys = 8 >> xd, 8 >> yd
            wy = (by * ys)[:, None, None] + np.arange(ys)[None, :, None]
            wx = (bx * xs)[:, None, None] + np.arange(xs)[None, None, :]
            # clip to the visible area (edge blocks are partially outside)
            wyc = np.minimum(wy, ph - 1)
            wxc = np.minimum(wx, pw - 1)
            inside = (wy < ph) & (wx < pw)
            d = rec[wyc, wxc].astype(np.int64) - src[wyc, wxc]
            d *= d
            d = np.where(inside, d, 0)
            np.add.at(total, sb_of_block, d.sum(axis=(1, 2)))
        return total

    from encbench.reference.av1 import native
    from encbench.reference.av1.config import ChromaSampling

    lib = native.get_lib()
    nplanes = 1 if cs == ChromaSampling.Cs400 else 3
    itemsize = rec_frame.planes[0].data.itemsize
    if lib is not None and itemsize in (1, 2):
        # single native sweep: filter every candidate per block in-register
        # and bin the SSE per superblock (no frame copies)
        pre_addr = np.zeros(nplanes, dtype=np.int64)
        src_addr = np.zeros(nplanes, dtype=np.int64)
        pre_stride = np.zeros(nplanes, dtype=np.int64)
        src_stride = np.zeros(nplanes, dtype=np.int64)
        xd_arr = np.zeros(nplanes, dtype=np.int32)
        yd_arr = np.zeros(nplanes, dtype=np.int32)
        vw = np.zeros(nplanes, dtype=np.int64)
        vh = np.zeros(nplanes, dtype=np.int64)
        views = []  # keep the plane views alive across the ctypes call
        for p in range(nplanes):
            rp = rec_frame.planes[p]
            sp = src_frame.planes[p]
            pad = rp.cfg.pad
            rv = rp.data[pad:, pad:]
            sv = sp.data[pad:, pad:]
            views += [rv, sv]
            pre_addr[p] = rv.ctypes.data
            src_addr[p] = sv.ctypes.data
            pre_stride[p] = rv.strides[0] // itemsize
            src_stride[p] = sv.strides[0] // itemsize
            xd_arr[p] = rp.cfg.xdec
            yd_arr[p] = rp.cfg.ydec
            vw[p] = (crop_w + (1 << rp.cfg.xdec) - 1) >> rp.cfg.xdec
            vh[p] = (crop_h + (1 << rp.cfg.ydec) - 1) >> rp.cfg.ydec
        n = len(by)
        by32 = np.ascontiguousarray(by, dtype=np.int32)
        bx32 = np.ascontiguousarray(bx, dtype=np.int32)
        dirs32 = np.ascontiguousarray(state["dirs"], dtype=np.int32)
        vars32 = np.ascontiguousarray(state["variances"], dtype=np.int32)
        ht = np.ascontiguousarray(state["have_top"], dtype=np.uint8)
        hl = np.ascontiguousarray(state["have_left"], dtype=np.uint8)
        hr = np.ascontiguousarray(state["have_right"], dtype=np.uint8)
        hb = np.ascontiguousarray(state["have_bottom"], dtype=np.uint8)
        sb32 = np.ascontiguousarray(sb_of_block, dtype=np.int32)
        ys32 = np.ascontiguousarray(y_strengths, dtype=np.int32)
        us32 = np.ascontiguousarray(uv_strengths, dtype=np.int32)
        out = np.zeros(4 * sb_rows * sb_cols, dtype=np.int64)
        lib.enc_cdef_rdo(
            nplanes, pre_addr.ctypes.data, pre_stride.ctypes.data,
            src_addr.ctypes.data, src_stride.ctypes.data, itemsize,
            xd_arr.ctypes.data, yd_arr.ctypes.data, vw.ctypes.data,
            vh.ctypes.data, n, by32.ctypes.data, bx32.ctypes.data,
            dirs32.ctypes.data, vars32.ctypes.data, ht.ctypes.data,
            hl.ctypes.data, hr.ctypes.data, hb.ctypes.data, sb32.ctypes.data,
            4, ys32.ctypes.data, us32.ctypes.data, damping, bd,
            sb_rows * sb_cols, out.ctypes.data,
        )
        sses = list(out.reshape(4, -1))
    else:
        sses = []
        for ci in range(4):
            work = _frame_scratch(rec_frame)
            cdef_filter_frame(
                (damping, y_strengths[ci], uv_strengths[ci]), work, blocks,
                bd, cs, crop_w, crop_h, state=state,
            )
            sses.append(filtered_block_sse(work))
    idx_map = (
        np.argmin(np.stack(sses), axis=0).reshape(sb_rows, sb_cols).astype(np.int32)
    )
    return y_strengths, uv_strengths, idx_map, state
