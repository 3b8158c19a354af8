"""Device in-loop filter stage: CDEF direction search, strength RD sweep and
apply over whole planes.

Counterpart of ``rav1e_tpu/device/filters.py``.  Every 8x8 cell is filtered
for every candidate strength at once, the per-64x64 argmin picks the
strength map, and the chosen reconstruction comes back in one copy.

All arithmetic is exact integer.  Sums that can exceed 31 bits are int64
(the reference splits them into 16-bit (hi, lo) pairs because its device has
no 64-bit integers).  The direction partial sums are a float64 matrix
product, exact for these magnitudes and untouched by TF32 settings.
"""

from __future__ import annotations

import numpy as np
import torch

from rav1e_tpu_torch.ops.cdef import (
    CDEF_DIRECTIONS,
    CDEF_SEC_STRENGTHS,
    CDEF_VERY_LARGE,
    _DIV_TABLE,
)
from rav1e_tpu_torch.device.constants import on as _tables

_I64 = torch.int64


def _msb(v):
    """floor(log2(v)) for v >= 1 (exact, integer shifts only)."""
    r = torch.zeros_like(v)
    for s in (16, 8, 4, 2, 1):
        m = v >= (1 << s)
        r = r + torch.where(m, s, 0)
        v = torch.where(m, v >> s, v)
    return r


# ---------------------------------------------------------------------------
# direction / variance estimation (ops/cdef.py cdef_find_dirs, exact)
# ---------------------------------------------------------------------------


def cdef_dirs_cells(cells, bd: int):
    """cells: (..., 8, 8) int luma.  Returns (dir, var) int64 (...,)."""
    x = (cells.to(_I64) >> (bd - 8)) - 128
    flat = x.reshape(x.shape[:-2] + (64,)).to(torch.float64)
    partial = torch.matmul(flat, _tables(cells.device).cdef_partial)
    p = partial.to(_I64).reshape(x.shape[:-2] + (8, 15))
    div = [int(d) for d in _DIV_TABLE]
    sq = p * p

    costs = []
    for d in range(8):
        q = sq[..., d, :]
        if d in (2, 6):
            c = q[..., :8].sum(-1) * div[8]
        elif d in (0, 4):
            c = q[..., 7] * div[8]
            for i in range(7):
                c = c + (q[..., i] + q[..., 14 - i]) * div[i + 1]
        else:
            c = q[..., 3:8].sum(-1) * div[8]
            for j in range(3):
                c = c + (q[..., j] + q[..., 10 - j]) * div[2 * j + 2]
        costs.append(c)
    cost = torch.stack(costs, dim=-1)  # (..., 8)

    # argmax with ties -> first index (np.argmax semantics)
    best_dir = torch.argmax(cost, dim=-1)
    best = torch.gather(cost, -1, best_dir[..., None])[..., 0]
    ortho = torch.gather(cost, -1, ((best_dir + 4) & 7)[..., None])[..., 0]
    return best_dir, (best - ortho) >> 10


# ---------------------------------------------------------------------------
# filter core (ops/cdef.py cdef_filter_blocks, exact) over a cell grid
# ---------------------------------------------------------------------------


def _shifted(win, dy: int, dx: int, ys: int, xs: int):
    return win[..., 2 + dy : 2 + dy + ys, 2 + dx : 2 + dx + xs]


def cdef_tap_precompute(win, dirs):
    """The 12 displaced-neighbour tensors for a per-cell direction field
    (or one static int direction), in tap order (k, which, sgn), with the
    min/max envelopes and the differences to the centre pixel.  They depend
    only on the direction field, so every strength candidate shares them."""
    ys = win.shape[-2] - 4
    xs = win.shape[-1] - 4
    x = _shifted(win, 0, 0, ys, xs)
    mx = x
    mn = x
    ps = []
    static_dir = isinstance(dirs, int)
    dir_sets = [dirs, (dirs + 2) & 7, (dirs + 6) & 7]
    for k in range(2):
        for dset in dir_sets:
            for sgn in (1, -1):
                if static_dir:
                    dy = int(CDEF_DIRECTIONS[dset, k, 0]) * sgn
                    dx = int(CDEF_DIRECTIONS[dset, k, 1]) * sgn
                    p = _shifted(win, dy, dx, ys, xs)
                else:
                    p = None
                    for d in range(8):
                        dy = int(CDEF_DIRECTIONS[d, k, 0]) * sgn
                        dx = int(CDEF_DIRECTIONS[d, k, 1]) * sgn
                        sl = _shifted(win, dy, dx, ys, xs)
                        m = (dset == d)[..., None, None]
                        p = (torch.where(m, sl, 0) if p is None
                             else torch.where(m, sl, p))
                ps.append(p)
                valid = p != CDEF_VERY_LARGE
                mx = torch.where(valid, torch.maximum(p, mx), mx)
                mn = torch.minimum(p, mn)
    return {"x": x, "p": ps, "mn": mn, "mx": mx,
            "diff": [p - x for p in ps],
            "adiff": [(p - x).abs() for p in ps]}


def _constrain(diff, adiff, strength, shift):
    """The CDEF constrain(): sign(diff) * clip(strength - (|diff| >> shift),
    0, |diff|), and 0 where the strength is 0."""
    mag = torch.minimum(torch.clamp(strength - (adiff >> shift), min=0), adiff)
    con = torch.where(diff < 0, -mag, mag)
    return torch.where(strength == 0, 0, con)


def cdef_filter_from_taps(taps, pri, sec: int, damping: int, bd: int):
    """Filter using precomputed taps (cdef_tap_precompute); pri (nby, nbx)
    int64 per-cell primary strength, sec a python int."""
    x = taps["x"]
    pri_bit = (pri >> (bd - 8)) & 1
    pri_tap = [
        torch.where(pri_bit == 0, 4, 3)[..., None, None],
        torch.where(pri_bit == 0, 2, 3)[..., None, None],
    ]
    sec_taps = (2, 1)
    pri_b = pri[..., None, None]
    pri_shift = torch.clamp(damping - _msb(pri.clamp(min=1)), min=0)[
        ..., None, None
    ]
    sec_shift = max(0, damping - (max(sec, 1).bit_length() - 1))
    sec_t = torch.tensor(sec, dtype=x.dtype, device=x.device)

    total = torch.zeros_like(x)
    ti = 0
    for k in range(2):
        for which in range(3):
            for _sgn in (1, -1):
                diff = taps["diff"][ti]
                adiff = taps["adiff"][ti]
                ti += 1
                if which == 0:
                    total = total + pri_tap[k] * _constrain(
                        diff, adiff, pri_b, pri_shift)
                else:
                    total = total + sec_taps[k] * _constrain(
                        diff, adiff, sec_t, sec_shift)

    v = x + ((8 + total - (total < 0).to(total.dtype)) >> 4)
    return torch.minimum(torch.maximum(v, taps["mn"]), taps["mx"])


def cdef_filter_cells(win, dirs, pri, sec: int, damping: int, bd: int):
    """win: (nby, nbx, ys+4, xs+4) with CDEF_VERY_LARGE rings; dirs/pri:
    (nby, nbx) int64; sec a python int.  Returns filtered (nby, nbx, ys,
    xs)."""
    return cdef_filter_from_taps(cdef_tap_precompute(win, dirs), pri, sec,
                                 damping, bd)


# ---------------------------------------------------------------------------
# whole-frame CDEF stage
# ---------------------------------------------------------------------------


def _cell_windows(plane_g, nby, nbx, ys, xs):
    """plane_g: (nby*ys + 4, nbx*xs + 4) (2px ring included).  Returns
    (nby, nbx, ys+4, xs+4) overlapping cell windows (a strided view)."""
    return plane_g.unfold(0, ys + 4, ys).unfold(1, xs + 4, xs)


def _ring_mask(win, have_t, have_l, have_r, have_b):
    ys4, xs4 = win.shape[-2], win.shape[-1]
    dev = win.device
    top = (torch.arange(ys4, device=dev) < 2)[:, None]
    bot = (torch.arange(ys4, device=dev) >= ys4 - 2)[:, None]
    left = (torch.arange(xs4, device=dev) < 2)[None, :]
    right = (torch.arange(xs4, device=dev) >= xs4 - 2)[None, :]
    ring = CDEF_VERY_LARGE
    win = torch.where((~have_t)[..., None, None] & top, ring, win)
    win = torch.where((~have_l)[..., None, None] & left, ring, win)
    win = torch.where((~have_r)[..., None, None] & right, ring, win)
    win = torch.where((~have_b)[..., None, None] & bot, ring, win)
    return win


def _strength_lists(base_y: int, base_uv: int):
    """The 4-entry luma / chroma candidate lists of host cdef_rdo_frame."""
    pri = base_y // CDEF_SEC_STRENGTHS
    sec = base_y % CDEF_SEC_STRENGTHS
    y = [0, base_y, max(pri // 2, 1) * CDEF_SEC_STRENGTHS + sec,
         min(pri * 2 + 1, 15) * CDEF_SEC_STRENGTHS + sec]
    pri_uv = base_uv // CDEF_SEC_STRENGTHS
    sec_uv = base_uv % CDEF_SEC_STRENGTHS
    uv = [0, base_uv, max(pri_uv // 2, 0) * CDEF_SEC_STRENGTHS + sec_uv,
          min(pri_uv * 2 + 1, 15) * CDEF_SEC_STRENGTHS + sec_uv]
    return y, uv


def cdef_stage_core(planes, grid, damping: int, bd: int, rec_grids,
                    src_grids, filt, y_str, uv_str):
    """CDEF stage for one frame.

    planes: per-plane (ys, xs, vis_h, vis_w), luma first (cell dims ys/xs
    are 8 >> ydec / 8 >> xdec).  grid: (nby, nbx, sb_rows, sb_cols, crop_w,
    crop_h).  rec_grids[p]: (nby*ys + 4, nbx*xs + 4) integer tensor (the mi
    extent plus the 2px ring read by the filter); src_grids[p]: (nby*ys,
    nbx*xs); filt: (nby, nbx) bool (non-skip cells); y_str/uv_str: lists of
    packed candidate strengths.

    Returns (outs, idx_map): the filtered mi-extent planes (int64) and the
    (sb_rows, sb_cols) int64 per-SB candidate index.
    """
    nby, nbx, sb_rows, sb_cols, crop_w, crop_h = grid
    ncand = len(y_str)
    dev = filt.device
    by = torch.arange(nby, device=dev)
    bx = torch.arange(nbx, device=dev)
    coeff_shift = bd - 8

    have_top = (by > 0)[:, None].expand(nby, nbx)
    have_left = (bx > 0)[None, :].expand(nby, nbx)
    have_right = (((bx + 2) * 8) <= crop_w)[None, :].expand(nby, nbx)
    have_bottom = (((by + 2) * 8) <= crop_h)[:, None].expand(nby, nbx)

    rec_grids = [g.to(_I64) for g in rec_grids]
    src_grids = [g.to(_I64) for g in src_grids]

    # direction search on the luma cells (from the pre-CDEF rec)
    ys0, xs0 = planes[0][0], planes[0][1]
    luma = rec_grids[0][2 : 2 + nby * ys0, 2 : 2 + nbx * xs0]
    cells = luma.reshape(nby, ys0, nbx, xs0).permute(0, 2, 1, 3)
    dirs, variances = cdef_dirs_cells(cells, bd)
    # luma primary-strength adjustment by the direction variance
    var6 = variances >> 6
    var_idx = torch.where(var6 != 0, _msb(var6.clamp(min=1)).clamp(max=12), 0)

    sse = torch.zeros((ncand, nby, nbx), dtype=_I64, device=dev)
    cand_cells = []
    for pi, (ys, xs, vh, vw) in enumerate(planes):
        win = _cell_windows(rec_grids[pi], nby, nbx, ys, xs)
        win = _ring_mask(win, have_top, have_left, have_right, have_bottom)
        src = src_grids[pi].reshape(nby, ys, nbx, xs).permute(0, 2, 1, 3)
        rows_in = ((by[:, None] * ys + torch.arange(ys, device=dev)[None, :])
                   < vh)[:, None, :, None]
        cols_in = ((bx[:, None] * xs + torch.arange(xs, device=dev)[None, :])
                   < vw)[None, :, None, :]
        inside = rows_in & cols_in

        damp = damping + coeff_shift - (0 if pi == 0 else 1)
        if pi > 0 and ys != xs:
            base_dir = _tables(dev).cdef_uv_dir_422[dirs]
        else:
            base_dir = dirs
        # taps depend only on the direction field: the real-dirs variant and
        # the dir-0 variant (used when pri == 0)
        taps_dir = cdef_tap_precompute(win, base_dir)
        taps_0 = cdef_tap_precompute(win, 0)
        plane_cands = []
        for ci in range(ncand):
            v = y_str[ci] if pi == 0 else uv_str[ci]
            pri_u = v // CDEF_SEC_STRENGTHS
            sec_u = v % CDEF_SEC_STRENGTHS
            sec_u += sec_u == 3
            sec_s = sec_u << coeff_shift
            if pri_u == 0:
                p0 = torch.zeros_like(dirs)
            elif pi == 0:
                strength = pri_u << coeff_shift
                p0 = torch.where(variances != 0,
                                 (strength * (4 + var_idx) + 8) >> 4, 0)
            else:
                p0 = torch.full_like(dirs, pri_u << coeff_shift)
            taps = taps_dir if pri_u != 0 else taps_0
            fcells = cdef_filter_from_taps(taps, p0, sec_s, damp, bd)
            plane_cands.append(fcells)
            d = torch.where(inside, fcells - src, 0)
            cell_sse = (d * d).sum(dim=(-1, -2))
            sse[ci] += torch.where(filt, cell_sse, 0)
        cand_cells.append(torch.stack(plane_cands))

    # reduce per SB, argmin (ties -> lowest index)
    pad_y = sb_rows * 8 - nby
    pad_x = sb_cols * 8 - nbx
    sse = torch.nn.functional.pad(sse, (0, pad_x, 0, pad_y))
    sb = sse.reshape(ncand, sb_rows, 8, sb_cols, 8).sum(dim=(2, 4))
    idx = torch.argmin(sb, dim=0)

    cell_idx = idx[(by // 8).clamp(max=sb_rows - 1)][
        :, (bx // 8).clamp(max=sb_cols - 1)
    ]
    outs = []
    for pi, (ys, xs, vh, vw) in enumerate(planes):
        cands = cand_cells[pi]  # (ncand, nby, nbx, ys, xs)
        chosen = torch.gather(
            cands, 0, cell_idx[None, :, :, None, None].expand(1, nby, nbx, ys, xs)
        )[0]
        pre_cells = (
            rec_grids[pi][2 : 2 + nby * ys, 2 : 2 + nbx * xs]
            .reshape(nby, ys, nbx, xs)
            .permute(0, 2, 1, 3)
        )
        final = torch.where(filt[..., None, None], chosen, pre_cells)
        outs.append(final.permute(0, 2, 1, 3).reshape(nby * ys, nbx * xs))
    return outs, idx


# ---------------------------------------------------------------------------
# host wrapper: upload rec/src, run the stage, write decisions + planes back
# ---------------------------------------------------------------------------


def _to_device(a: np.ndarray, device):
    a = np.ascontiguousarray(a)
    if a.dtype != np.uint8:
        a = a.astype(np.int32)  # 10/12-bit planes: widen on the host
    return torch.from_numpy(a).to(device)


def cdef_device_frame(rec_frame, src_frame, blocks, bd, cs, crop_w, crop_h,
                      damping, base_y, base_uv, *, device):
    """Device CDEF RD search + apply on ``device`` (drop-in for host
    cdef_rdo_frame + cdef_filter_frame).

    Returns (y_strengths, uv_strengths, idx_map, applied) and applies the
    chosen filtering to rec_frame in place.  Candidate lists match host
    cdef_rdo_frame exactly.
    """
    from rav1e_tpu_torch.config import ChromaSampling

    y_strengths, uv_strengths = _strength_lists(base_y, base_uv)
    sb_rows = (crop_h + 63) // 64
    sb_cols = (crop_w + 63) // 64
    mi_cols, mi_rows = blocks.cols, blocks.rows
    nbx = (mi_cols + 1) // 2
    nby = (mi_rows + 1) // 2

    sk = np.ones((nby * 2, nbx * 2), dtype=bool)
    sk[:mi_rows, :mi_cols] = blocks.skip
    filt_np = ~(sk.reshape(nby, 2, nbx, 2).all(axis=(1, 3)))
    if not filt_np.any():
        return (y_strengths, uv_strengths,
                np.zeros((sb_rows, sb_cols), np.int32), False)

    nplanes = 1 if cs == ChromaSampling.Cs400 else 3
    planes_geom = []
    rec_grids = []
    src_grids = []
    for p in range(nplanes):
        rp = rec_frame.planes[p]
        sp = src_frame.planes[p]
        xd, yd = (0, 0) if p == 0 else cs.decimation()
        ys, xs = 8 >> yd, 8 >> xd
        vh = (crop_h + (1 << yd) - 1) >> yd
        vw = (crop_w + (1 << xd) - 1) >> xd
        planes_geom.append((ys, xs, vh, vw))
        pad = rp.cfg.pad
        gh, gw = nby * ys, nbx * xs
        rec_grids.append(
            _to_device(rp.data[pad - 2 : pad + gh + 2, pad - 2 : pad + gw + 2],
                       device))
        src_grids.append(_to_device(sp.data[pad : pad + gh, pad : pad + gw],
                                    device))

    outs, idx = cdef_stage_core(
        planes_geom, (nby, nbx, sb_rows, sb_cols, crop_w, crop_h), damping,
        bd, rec_grids, src_grids, torch.from_numpy(filt_np).to(device),
        y_strengths, uv_strengths,
    )
    for p in range(nplanes):
        rp = rec_frame.planes[p]
        pad = rp.cfg.pad
        ys, xs, _, _ = planes_geom[p]
        gh, gw = nby * ys, nbx * xs
        rp.data[pad : pad + gh, pad : pad + gw] = (
            outs[p].cpu().numpy().astype(rp.data.dtype)
        )
    return y_strengths, uv_strengths, idx.cpu().numpy().astype(np.int32), True
