"""Lookahead cost estimation + temporal-RDO importance propagation.

Capability counterpart of the reference's ``src/api/lookahead.rs``
(``estimate_intra_costs``/``estimate_inter_costs``/``compute_motion_vectors``)
and the block-importance propagation in ``src/api/internal.rs:912-1259``:
well-predicted blocks that future frames reference earn a distortion-scale
boost so their quality propagates down the reference chain.

Cost grids use 8x8 importance blocks (reference ``IMPORTANCE_BLOCK_SIZE``);
lookahead motion runs on 16x16 blocks and is shared across the four 8x8
cells it covers.  All grid math is dense numpy (the grids are tiny); the
per-block ME reuses the native diamond search with a bit-identical python
fallback so native availability never changes decisions.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

IMP_BLOCK = 8  # importance block size in pixels
ME_BLOCK = 16  # lookahead motion block size


def estimate_intra_costs(luma: np.ndarray, bit_depth: int) -> np.ndarray:
    """Per-8x8 intra cost proxy (lookahead.rs:30): prediction-residual
    energy of a DC+gradient model — cheap, monotone with true intra rate."""
    h, w = luma.shape
    nby, nbx = h // IMP_BLOCK, w // IMP_BLOCK
    if nby == 0 or nbx == 0:
        return np.ones((max(nby, 1), max(nbx, 1)), dtype=np.float64)
    from rav1e_tpu_torch import native as _native

    lib = _native.get_lib()
    if (
        lib is not None
        and luma.dtype.itemsize in (1, 2)
        and luma.strides[1] == luma.itemsize
    ):
        out = np.empty((nby, nbx), dtype=np.float64)
        lib.enc_la_intra_costs(
            luma.ctypes.data, luma.strides[0] // luma.itemsize,
            luma.itemsize, h, w, bit_depth, out.ctypes.data,
        )
        return out
    a = luma[: nby * IMP_BLOCK, : nbx * IMP_BLOCK].astype(np.float64)
    cells = a.reshape(nby, IMP_BLOCK, nbx, IMP_BLOCK)
    dc = cells.mean(axis=(1, 3), keepdims=True)
    row_m = cells.mean(axis=3, keepdims=True)  # H-pred analog
    col_m = cells.mean(axis=1, keepdims=True)  # V-pred analog
    best = np.minimum.reduce(
        [
            np.abs(cells - dc).sum(axis=(1, 3)),
            np.abs(cells - row_m).sum(axis=(1, 3)),
            np.abs(cells - col_m).sum(axis=(1, 3)),
        ]
    )
    return np.maximum(best / (1 << (bit_depth - 8)), 1.0)


def lookahead_motion(src: np.ndarray, ref: np.ndarray, bit_depth: int,
                     seeds: np.ndarray = None):
    """Full-pel 16x16 diamond ME vs one reference (compute_motion_vectors,
    lookahead.rs:271).  ``seeds``: optional (nby, nbx, 2) per-block starting
    MVs (from a coarser pyramid level).  Returns
    (mvs (nby, nbx, 2) int in px, sad (nby, nbx))."""
    h, w = src.shape
    nby, nbx = max(h // ME_BLOCK, 1), max(w // ME_BLOCK, 1)
    mvs = np.zeros((nby, nbx, 2), dtype=np.int32)
    sads = np.zeros((nby, nbx), dtype=np.float64)

    from rav1e_tpu_torch import native

    lib = native.get_lib()
    if (
        lib is not None
        and src.itemsize in (1, 2)
        and src.strides[1] == src.itemsize
        and ref.strides[1] == ref.itemsize
    ):
        seeds_arr = None
        seeds_ptr = None
        if seeds is not None:
            seeds_arr = np.ascontiguousarray(seeds[:nby, :nbx], dtype=np.int32)
            if seeds_arr.shape != (nby, nbx, 2):
                pad = np.zeros((nby, nbx, 2), np.int32)
                pad[: seeds_arr.shape[0], : seeds_arr.shape[1]] = seeds_arr
                seeds_arr = pad
            seeds_ptr = seeds_arr.ctypes.data
        lib.enc_lookahead_me(
            src.ctypes.data, src.strides[0] // src.itemsize,
            ref.ctypes.data, ref.strides[0] // ref.itemsize,
            src.itemsize, h, w, seeds_ptr,
            mvs.ctypes.data, sads.ctypes.data, bit_depth,
        )
        return mvs, sads

    norm = 1 << (bit_depth - 8)
    for by in range(nby):
        for bx in range(nbx):
            py, px = by * ME_BLOCK, bx * ME_BLOCK
            bh = min(ME_BLOCK, h - py)
            bw = min(ME_BLOCK, w - px)
            block = src[py : py + bh, px : px + bw].astype(np.int32)

            def sad_at(dy, dx):
                ry, rx = py + dy, px + dx
                if ry < 0 or rx < 0 or ry + bh > h or rx + bw > w:
                    return None
                return int(
                    np.abs(block - ref[ry : ry + bh, rx : rx + bw]).sum()
                )

            cand_seeds = [(0, 0)]
            if seeds is not None:
                sy = min(by, seeds.shape[0] - 1)
                sx = min(bx, seeds.shape[1] - 1)
                cand_seeds.append((int(seeds[sy, sx, 0]), int(seeds[sy, sx, 1])))
            best_mv, best = None, None
            for sd in cand_seeds:
                c = sad_at(*sd)
                if c is not None and (best is None or c < best):
                    best_mv, best = sd, c
            if best is None:
                best_mv, best = (0, 0), sad_at(0, 0) or 0
            for step in (8, 4, 2, 1):
                improved = True
                while improved:
                    improved = False
                    for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                        cand = (best_mv[0] + dy * step, best_mv[1] + dx * step)
                        c = sad_at(*cand)
                        if c is not None and c < best:
                            best_mv, best = cand, c
                            improved = True
            mvs[by, bx] = best_mv
            sads[by, bx] = best / norm
    return mvs, sads


def _down2(a: np.ndarray) -> np.ndarray:
    h2, w2 = (a.shape[0] // 2) * 2, (a.shape[1] // 2) * 2
    if h2 < 2 or w2 < 2:
        return a.copy()
    return (
        a[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2).mean(axis=(1, 3))
    ).astype(a.dtype)


def _upsample_mvs(mvs: np.ndarray, nby: int, nbx: int) -> np.ndarray:
    """Scale a coarser MV grid x2 (pixels) and repeat to the finer grid."""
    up = np.repeat(np.repeat(mvs * 2, 2, axis=0), 2, axis=1)
    out = np.zeros((nby, nbx, 2), dtype=np.int32)
    ys = np.minimum(np.arange(nby), up.shape[0] - 1)
    xs = np.minimum(np.arange(nbx), up.shape[1] - 1)
    out[:] = up[ys[:, None], xs[None, :]]
    return out


def hierarchical_me(src: np.ndarray, ref: np.ndarray, bit_depth: int):
    """3-pass pyramid motion (estimate_tile_motion, me.rs:153-284):
    quarter-res diamond, then half- and full-res refinement with scaled
    seeds.  Returns the full-res (nby, nbx, 2) field in pixel units on the
    16x16 grid (callers convert to 1/8-pel)."""
    src_h, ref_h = _down2(src), _down2(ref)
    src_q, ref_q = _down2(src_h), _down2(ref_h)
    mv_q, _ = lookahead_motion(src_q, ref_q, bit_depth)
    nby_h = max(src_h.shape[0] // ME_BLOCK, 1)
    nbx_h = max(src_h.shape[1] // ME_BLOCK, 1)
    mv_h, _ = lookahead_motion(
        src_h, ref_h, bit_depth, seeds=_upsample_mvs(mv_q, nby_h, nbx_h)
    )
    nby = max(src.shape[0] // ME_BLOCK, 1)
    nbx = max(src.shape[1] // ME_BLOCK, 1)
    mv_f, _ = lookahead_motion(
        src, ref, bit_depth, seeds=_upsample_mvs(mv_h, nby, nbx)
    )
    return mv_f


def inter_costs_8x8(mvs: np.ndarray, src: np.ndarray, ref: np.ndarray,
                    bit_depth: int) -> np.ndarray:
    """Per-8x8 inter cost: SAD of the motion-compensated 16x16 parent,
    measured per 8x8 quadrant (estimate_inter_costs, lookahead.rs:182)."""
    h, w = src.shape
    from rav1e_tpu_torch import native as _native

    lib = _native.get_lib()
    if (
        lib is not None
        and src.dtype.itemsize in (1, 2)
        and src.dtype == ref.dtype
        and src.strides[1] == src.itemsize
        and ref.strides[1] == ref.itemsize
    ):
        nby, nbx = max(h // IMP_BLOCK, 1), max(w // IMP_BLOCK, 1)
        out = np.empty((nby, nbx), dtype=np.float64)
        mv32 = np.ascontiguousarray(mvs, dtype=np.int32)
        lib.enc_inter_costs_8x8(
            src.ctypes.data, src.strides[0] // src.itemsize,
            ref.ctypes.data, ref.strides[0] // ref.itemsize,
            src.itemsize, h, w, mv32.ctypes.data,
            mv32.shape[0], mv32.shape[1], bit_depth, out.ctypes.data,
        )
        return out
    nby, nbx = max(h // IMP_BLOCK, 1), max(w // IMP_BLOCK, 1)
    out = np.ones((nby, nbx), dtype=np.float64)
    norm = 1 << (bit_depth - 8)
    for by in range(nby):
        for bx in range(nbx):
            py, px = by * IMP_BLOCK, bx * IMP_BLOCK
            bh = min(IMP_BLOCK, h - py)
            bw = min(IMP_BLOCK, w - px)
            mv = mvs[min(by // 2, mvs.shape[0] - 1), min(bx // 2, mvs.shape[1] - 1)]
            ry = min(max(py + int(mv[0]), 0), h - bh)
            rx = min(max(px + int(mv[1]), 0), w - bw)
            out[by, bx] = max(
                float(
                    np.abs(
                        src[py : py + bh, px : px + bw].astype(np.int32)
                        - ref[ry : ry + bh, rx : rx + bw]
                    ).sum()
                )
                / norm,
                1.0,
            )
    return out


def propagate_importance(
    importances: np.ndarray,
    intra: np.ndarray,
    inter: np.ndarray,
    mvs: np.ndarray,
    ref_importances: np.ndarray,
) -> None:
    """Back-propagate one frame's importance onto its reference
    (internal.rs:1030-1160 block_importances): each 8x8 block forwards
    ``(intra_cost + importance) * (1 - inter/intra)`` to the reference
    area its motion vector points at, split by bilinear overlap."""
    nby, nbx = intra.shape
    fract = np.clip(1.0 - inter / np.maximum(intra, 1e-6), 0.0, 1.0)
    amount = (intra + importances) * fract
    rby, rbx = ref_importances.shape
    from rav1e_tpu_torch import native as _native

    lib = _native.get_lib()
    if lib is not None:
        am = np.ascontiguousarray(amount, dtype=np.float64)
        mv32 = np.ascontiguousarray(mvs, dtype=np.int32)
        ri = ref_importances
        assert ri.flags.c_contiguous and ri.dtype == np.float64
        lib.enc_propagate_importance(
            am.ctypes.data, nby, nbx, mv32.ctypes.data,
            mv32.shape[0], mv32.shape[1], ri.ctypes.data, rby, rbx,
        )
        return
    for by in range(nby):
        for bx in range(nbx):
            a = amount[by, bx]
            if a <= 0.0:
                continue
            mv = mvs[min(by // 2, mvs.shape[0] - 1), min(bx // 2, mvs.shape[1] - 1)]
            # reference position in 8x8 block units (fractional)
            fy = by + mv[0] / IMP_BLOCK
            fx = bx + mv[1] / IMP_BLOCK
            y0, x0 = int(np.floor(fy)), int(np.floor(fx))
            wy, wx = fy - y0, fx - x0
            for dy, wy_ in ((0, 1.0 - wy), (1, wy)):
                for dx, wx_ in ((0, 1.0 - wx), (1, wx)):
                    ty, tx = y0 + dy, x0 + dx
                    if 0 <= ty < rby and 0 <= tx < rbx:
                        ref_importances[ty, tx] += a * wy_ * wx_


def importances_to_scales(importances: np.ndarray, intra: np.ndarray) -> np.ndarray:
    """Distortion scales from propagated importance (rdo.rs
    distortion_scale/spatiotemporal_scale analog): scale grows with the
    future savings referenced through this block, clamped to [1, 4]."""
    rel = importances / np.maximum(intra, 1e-6)
    return np.clip(np.sqrt(1.0 + rel), 1.0, 4.0)


class LookaheadData:
    """Per-input-frame lookahead grids, keyed off the 8x-luma."""

    __slots__ = ("intra", "inter", "mvs", "importances")

    def __init__(self, intra, inter=None, mvs=None):
        self.intra = intra
        self.inter = inter
        self.mvs = mvs
        self.importances = np.zeros_like(intra)
