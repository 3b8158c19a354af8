"""Device in-loop filter stage: CDEF direction search, strength RD sweep and
apply over whole planes.

Counterpart of ``rav1e_tpu/device/filters.py``.  :func:`cdef_stage_core`
runs three kernels of ``csrc/cdef.cu``, each with its plain PyTorch version
here, which a CPU tensor takes: :func:`cdef_dirs` (direction and variance
per 8x8 luma cell), :func:`cdef_search` (every cell filtered at every
candidate strength, only the per-cell SSE kept) and :func:`cdef_apply` (the
per-64x64 argmin, then each cell filtered again at its superblock's
candidate).  The reference's one XLA program materialises every candidate's
filtered cells instead.  The standalone stage (:func:`cdef_device_frame`)
runs through a pipeline's ``device/graphs.CdefPrograms``, on a card one
CUDA graph per key after the key's first frame, the counterpart of the
reference's ``cdef_stage_jit``; the chain captures :func:`cdef_stage_core`
inside its own graphs.  The strength lists are host ints (part of a
runner's key), passed to the kernels as scalars.

All arithmetic is exact integer.  Sums that can exceed 31 bits are int64
(the reference splits them into 16-bit (hi, lo) pairs because its device has
no 64-bit integers).  The plain direction partial sums are a float64 matrix
product, exact for these magnitudes and untouched by TF32 settings.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from rav1e_tpu_torch.ops.cdef import (
    CDEF_DIRECTIONS,
    CDEF_SEC_STRENGTHS,
    CDEF_VERY_LARGE,
    _DIV_TABLE,
)
from rav1e_tpu_torch.device import _build, kernels
from rav1e_tpu_torch.device.constants import device_cache
from rav1e_tpu_torch.device.constants import on as _tables

_I32 = torch.int32
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


@device_cache
def _scalar(v: int, dtype, device):
    """A 0-d tensor on ``device``, made once: the chain's CUDA graphs
    capture this stage, and a capture cannot copy from the host."""
    return torch.tensor(v, dtype=dtype, device=device)


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
    sec_t = _scalar(sec, x.dtype, x.device)

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
    """CDEF stage for one frame: :func:`cdef_dirs`, :func:`cdef_search` and
    :func:`cdef_apply`, each a kernel of ``csrc/cdef.cu`` on a card and its
    plain version on the CPU.

    planes: per-plane (ys, xs, vis_h, vis_w), luma first (cell dims ys/xs
    are 8 >> ydec / 8 >> xdec).  grid: (nby, nbx, sb_rows, sb_cols, crop_w,
    crop_h).  rec_grids[p]: (nby*ys + 4, nbx*xs + 4) integer tensor (the mi
    extent plus the 2px ring read by the filter); src_grids[p]: (nby*ys,
    nbx*xs); filt: (nby, nbx) bool (non-skip cells); y_str/uv_str: lists of
    packed candidate strengths (host ints: part of a replayed program's
    key).  Samples lie in [0, 2^bd).

    Returns (outs, idx_map): the filtered mi-extent planes (int64) and the
    (sb_rows, sb_cols) int64 per-SB candidate index.
    """
    rec_grids = [g.to(_I32).contiguous() for g in rec_grids]
    src_grids = [g.to(_I32).contiguous() for g in src_grids]
    filt = filt.contiguous()
    dirs, var = cdef_dirs(rec_grids[0], grid[0], grid[1], bd)
    sse = cdef_search(planes, grid, damping, bd, rec_grids, src_grids, filt,
                      dirs, var, y_str, uv_str)
    return cdef_apply(planes, grid, damping, bd, rec_grids, filt, dirs, var,
                      sse, y_str, uv_str)


# ---------------------------------------------------------------------------
# the stage's kernels (csrc/cdef.cu): plain versions, input checks, wrappers
# ---------------------------------------------------------------------------

MAX_CANDIDATES = 4  # the strength lists csrc/cdef.cu takes


def cdef_dirs_plain(luma_grid, nby: int, nbx: int, bd: int):
    """(nby*8 + 4, nbx*8 + 4) luma grid -> the direction and variance of
    each 8x8 cell inside the ring, int32 (nby, nbx) each
    (:func:`cdef_dirs_cells`)."""
    luma = luma_grid[2 : 2 + nby * 8, 2 : 2 + nbx * 8]
    cells = luma.reshape(nby, 8, nbx, 8).permute(0, 2, 1, 3)
    dirs, var = cdef_dirs_cells(cells, bd)
    return dirs.to(_I32), var.to(_I32)


def _candidate_cells(planes, grid, damping: int, bd: int, rec_grids, dirs,
                     var, y_str, uv_str):
    """Per plane, then per candidate: (plane, candidate, filtered cells
    (nby, nbx, ys, xs) int64), every cell filtered at the candidate."""
    nby, nbx, _sb_rows, _sb_cols, crop_w, crop_h = grid
    dev = dirs.device
    by = torch.arange(nby, device=dev)
    bx = torch.arange(nbx, device=dev)
    coeff_shift = bd - 8
    have_top = (by > 0)[:, None].expand(nby, nbx)
    have_left = (bx > 0)[None, :].expand(nby, nbx)
    have_right = (((bx + 2) * 8) <= crop_w)[None, :].expand(nby, nbx)
    have_bottom = (((by + 2) * 8) <= crop_h)[:, None].expand(nby, nbx)
    dirs = dirs.to(_I64)
    variances = var.to(_I64)
    # luma primary-strength adjustment by the direction variance
    var6 = variances >> 6
    var_idx = torch.where(var6 != 0, _msb(var6.clamp(min=1)).clamp(max=12), 0)
    for pi, (ys, xs, _vh, _vw) in enumerate(planes):
        win = _cell_windows(rec_grids[pi].to(_I64), nby, nbx, ys, xs)
        win = _ring_mask(win, have_top, have_left, have_right, have_bottom)
        damp = damping + coeff_shift - (0 if pi == 0 else 1)
        if pi > 0 and ys != xs:
            base_dir = _tables(dev).cdef_uv_dir_422[dirs]
        else:
            base_dir = dirs
        # taps depend only on the direction field: the real-dirs variant and
        # the dir-0 variant (used when pri == 0)
        taps_dir = cdef_tap_precompute(win, base_dir)
        taps_0 = cdef_tap_precompute(win, 0)
        for ci in range(len(y_str)):
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
            yield pi, ci, cdef_filter_from_taps(taps, p0, sec_s, damp, bd)


def _cells(plane, nby: int, nbx: int, ys: int, xs: int):
    """(nby*ys, nbx*xs) -> (nby, nbx, ys, xs) cells (a view)."""
    return plane.reshape(nby, ys, nbx, xs).permute(0, 2, 1, 3)


def cdef_search_plain(planes, grid, damping: int, bd: int, rec_grids,
                      src_grids, filt, dirs, var, y_str, uv_str):
    """The (ncand, nby, nbx) int64 SSE of every cell filtered at every
    candidate against the source, summed over the planes' visible samples;
    0 where ``filt`` is False."""
    nby, nbx = grid[0], grid[1]
    dev = dirs.device
    by = torch.arange(nby, device=dev)
    bx = torch.arange(nbx, device=dev)
    sse = torch.zeros((len(y_str), nby, nbx), dtype=_I64, device=dev)
    for pi, ci, fcells in _candidate_cells(planes, grid, damping, bd,
                                           rec_grids, dirs, var, y_str,
                                           uv_str):
        ys, xs, vh, vw = planes[pi]
        src = _cells(src_grids[pi].to(_I64), nby, nbx, ys, xs)
        rows_in = ((by[:, None] * ys + torch.arange(ys, device=dev)[None, :])
                   < vh)[:, None, :, None]
        cols_in = ((bx[:, None] * xs + torch.arange(xs, device=dev)[None, :])
                   < vw)[None, :, None, :]
        d = torch.where(rows_in & cols_in, fcells - src, 0)
        cell_sse = (d * d).sum(dim=(-1, -2))
        sse[ci] += torch.where(filt, cell_sse, 0)
    return sse


def cdef_apply_plain(planes, grid, damping: int, bd: int, rec_grids, filt,
                     dirs, var, sse, y_str, uv_str):
    """Per 64x64 superblock the candidate of least summed SSE (ties to the
    lowest index), then every ``filt`` cell filtered at its superblock's
    candidate and the others copied from the reconstruction.  Returns the
    (nby*ys, nbx*xs) int64 planes and the (sb_rows, sb_cols) int64 index."""
    nby, nbx, sb_rows, sb_cols, _crop_w, _crop_h = grid
    dev = dirs.device
    ncand = len(y_str)
    # reduce per SB (a negative pad crops cells past the last SB's 8)
    pad_y = sb_rows * 8 - nby
    pad_x = sb_cols * 8 - nbx
    sb = torch.nn.functional.pad(sse, (0, pad_x, 0, pad_y))
    sb = sb.reshape(ncand, sb_rows, 8, sb_cols, 8).sum(dim=(2, 4))
    idx = torch.argmin(sb, dim=0)
    by = torch.arange(nby, device=dev)
    bx = torch.arange(nbx, device=dev)
    cell_idx = idx[(by // 8).clamp(max=sb_rows - 1)][
        :, (bx // 8).clamp(max=sb_cols - 1)
    ][..., None, None]

    chosen = [None] * len(planes)
    for pi, ci, fcells in _candidate_cells(planes, grid, damping, bd,
                                           rec_grids, dirs, var, y_str,
                                           uv_str):
        chosen[pi] = (fcells if ci == 0
                      else torch.where(cell_idx == ci, fcells, chosen[pi]))
    outs = []
    for pi, (ys, xs, _vh, _vw) in enumerate(planes):
        pre = _cells(rec_grids[pi][2 : 2 + nby * ys, 2 : 2 + nbx * xs]
                     .to(_I64), nby, nbx, ys, xs)
        final = torch.where(filt[..., None, None], chosen[pi], pre)
        outs.append(final.permute(0, 2, 1, 3).reshape(nby * ys, nbx * xs))
    return outs, idx


def check_cdef_inputs(name: str, planes, grid, bd: int, rec_grids,
                      src_grids=None, filt=None, dirs=None, var=None,
                      sse=None, y_str=None, uv_str=None) -> None:
    """Raise unless the arguments given are what csrc/cdef.cu reads, on any
    device.  ``planes`` may be the luma plane alone (``cdef_dirs``)."""
    nby, nbx, sb_rows, sb_cols = grid[:4]
    dev = rec_grids[0].device
    if bd not in (8, 10, 12):
        raise ValueError(f"{name}: bit depth {bd}")
    if len(planes) not in (1, 3) or len(rec_grids) != len(planes):
        raise ValueError(f"{name}: {len(planes)} planes, {len(rec_grids)} "
                         "grids")
    if min(nby, nbx, sb_rows, sb_cols) < 1:
        raise ValueError(f"{name}: empty grid {tuple(grid)}")
    want = []
    for pi, (ys, xs, *_vis) in enumerate(planes):
        if (ys, xs) != (8, 8) and (pi == 0 or ys not in (4, 8)
                                   or xs not in (4, 8)):
            raise ValueError(f"{name}: plane {pi} cells {ys}x{xs}")
        want.append((rec_grids[pi], torch.int32, (nby * ys + 4, nbx * xs + 4)))
        if src_grids is not None:
            want.append((src_grids[pi], torch.int32, (nby * ys, nbx * xs)))
    for t, dt in ((filt, torch.bool), (dirs, torch.int32),
                  (var, torch.int32)):
        if t is not None:
            want.append((t, dt, (nby, nbx)))
    if y_str is not None:
        if not 1 <= len(y_str) == len(uv_str) <= MAX_CANDIDATES:
            raise ValueError(f"{name}: strength lists of {len(y_str)} and "
                             f"{len(uv_str)}, not 1 to {MAX_CANDIDATES} each")
        if not all(0 <= v < 16 * CDEF_SEC_STRENGTHS
                   for v in (*y_str, *uv_str)):
            raise ValueError(f"{name}: strengths {y_str}, {uv_str}")
        if sse is not None:
            want.append((sse, torch.int64, (len(y_str), nby, nbx)))
    for t, dt, shape in want:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name}: expects {dt}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous tensors")


def _cdef_args(planes, grid, damping: int, bd: int, rec_grids, src_grids=(),
               outs=(), filt=None, dirs=None, var=None, sse=None, idx=None,
               y_str=(), uv_str=()):
    """The ``_build.CdefArgs`` of these tensors and numbers."""
    a = _build.CdefArgs()
    for pi, (ys, xs, vh, vw) in enumerate(planes):
        a.rec[pi] = rec_grids[pi].data_ptr()
        if src_grids:
            a.src[pi] = src_grids[pi].data_ptr()
        if outs:
            a.out[pi] = outs[pi].data_ptr()
        a.ys[pi], a.xs[pi], a.vh[pi], a.vw[pi] = ys, xs, vh, vw
    for field, t in (("filt", filt), ("dirs", dirs), ("var", var),
                     ("sse", sse), ("idx", idx)):
        if t is not None:
            setattr(a, field, t.data_ptr())
    (a.nby, a.nbx, a.sb_rows, a.sb_cols, a.crop_w, a.crop_h) = grid
    a.nplanes, a.damping, a.bd, a.ncand = len(planes), damping, bd, len(y_str)
    for i, (vy, vu) in enumerate(zip(y_str, uv_str)):
        a.y_str[i], a.uv_str[i] = vy, vu
    return a


def _launch(name: str, args, dev) -> None:
    with torch.cuda.device(dev):
        code = getattr(_build.lib(), f"r1t_{name}")(
            ctypes.byref(args), dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, name)
    kernels._count(name)


def cdef_dirs(luma_grid, nby: int, nbx: int, bd: int):
    """The direction and variance of each 8x8 luma cell, int32 (nby, nbx)
    each: :func:`cdef_dirs_plain` for a CPU tensor, csrc/cdef.cu's
    ``cdef_dirs`` for a CUDA one."""
    dev = luma_grid.device
    if dev.type == "cpu":
        return cdef_dirs_plain(luma_grid, nby, nbx, bd)
    kernels._require_cuda("cdef_dirs", dev)
    planes = ((8, 8, 8 * nby, 8 * nbx),)
    grid = (nby, nbx, 1, 1, 0, 0)
    check_cdef_inputs("cdef_dirs", planes, grid, bd, [luma_grid])
    dirs = torch.empty((nby, nbx), dtype=_I32, device=dev)
    var = torch.empty((nby, nbx), dtype=_I32, device=dev)
    _launch("cdef_dirs", _cdef_args(planes, grid, 0, bd, [luma_grid],
                                    dirs=dirs, var=var), dev)
    return dirs, var


def cdef_search(planes, grid, damping: int, bd: int, rec_grids, src_grids,
                filt, dirs, var, y_str, uv_str):
    """The (ncand, nby, nbx) int64 per-cell SSE of every candidate:
    :func:`cdef_search_plain` for CPU tensors, csrc/cdef.cu's
    ``cdef_search`` for CUDA ones (int32 grids, dirs and var, a bool
    ``filt``, all contiguous)."""
    dev = filt.device
    if dev.type == "cpu":
        return cdef_search_plain(planes, grid, damping, bd, rec_grids,
                                 src_grids, filt, dirs, var, y_str, uv_str)
    kernels._require_cuda("cdef_search", dev)
    check_cdef_inputs("cdef_search", planes, grid, bd, rec_grids, src_grids,
                      filt, dirs, var, y_str=y_str, uv_str=uv_str)
    sse = torch.empty((len(y_str), grid[0], grid[1]), dtype=_I64, device=dev)
    _launch("cdef_search", _cdef_args(
        planes, grid, damping, bd, rec_grids, src_grids, filt=filt,
        dirs=dirs, var=var, sse=sse, y_str=y_str, uv_str=uv_str), dev)
    return sse


def cdef_apply(planes, grid, damping: int, bd: int, rec_grids, filt, dirs,
               var, sse, y_str, uv_str):
    """The per-SB argmin and the filtered planes: :func:`cdef_apply_plain`
    for CPU tensors, csrc/cdef.cu's ``cdef_apply`` for CUDA ones.  Returns
    (outs, idx), int64."""
    dev = filt.device
    if dev.type == "cpu":
        return cdef_apply_plain(planes, grid, damping, bd, rec_grids, filt,
                                dirs, var, sse, y_str, uv_str)
    kernels._require_cuda("cdef_apply", dev)
    check_cdef_inputs("cdef_apply", planes, grid, bd, rec_grids, None, filt,
                      dirs, var, sse, y_str, uv_str)
    nby, nbx, sb_rows, sb_cols = grid[:4]
    outs = [torch.empty((nby * ys, nbx * xs), dtype=_I64, device=dev)
            for ys, xs, _vh, _vw in planes]
    idx = torch.empty((sb_rows, sb_cols), dtype=_I64, device=dev)
    _launch("cdef_apply", _cdef_args(
        planes, grid, damping, bd, rec_grids, outs=outs, filt=filt,
        dirs=dirs, var=var, sse=sse, idx=idx, y_str=y_str, uv_str=uv_str),
        dev)
    return outs, idx


# ---------------------------------------------------------------------------
# host wrapper: load rec/src, run the stage, write decisions + planes back
# ---------------------------------------------------------------------------


def _host_grid(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    if a.dtype != np.uint8:
        a = a.astype(np.int32)  # 10/12-bit planes: widen on the host
    return a


def cdef_device_frame(rec_frame, src_frame, blocks, bd, cs, crop_w, crop_h,
                      damping, base_y, base_uv, *, device, programs=None):
    """Device CDEF RD search + apply on ``device`` (drop-in for host
    cdef_rdo_frame + cdef_filter_frame).

    Returns (y_strengths, uv_strengths, idx_map, applied) and applies the
    chosen filtering to rec_frame in place.  Candidate lists match host
    cdef_rdo_frame exactly.  The stage runs through ``programs``, the
    caller's ``device/graphs.CdefPrograms`` (on a card one CUDA graph per
    key after the key's first frame); without one, through a runner of its
    own, whose only frame runs eagerly.
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
        rec_grids.append(_host_grid(
            rp.data[pad - 2 : pad + gh + 2, pad - 2 : pad + gw + 2]))
        src_grids.append(_host_grid(sp.data[pad : pad + gh, pad : pad + gw]))

    if programs is None:
        from rav1e_tpu_torch.device.graphs import CdefPrograms

        programs = CdefPrograms(device)
    outs, idx = programs.run(
        planes_geom, (nby, nbx, sb_rows, sb_cols, crop_w, crop_h), damping,
        bd, rec_grids, src_grids, filt_np, y_strengths, uv_strengths,
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
