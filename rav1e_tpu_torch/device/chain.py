"""Device reconstruction chain: the whole inter-frame recon path (candidate
selection -> MC -> forward transform -> quantize -> dequant/inverse
transform recon -> deblock -> CDEF) as five stages of PyTorch operations per
frame, with the reconstruction KEPT on the device as the next frames'
reference.

Counterpart of ``rav1e_tpu/device/chain.py``.  The host half is the native
replay coder (native/tile.cc coeff_log_mode=2 + reuse grids): a pixel-free
serial walk that turns the device's compact coefficient log + decision grids
into the AV1 symbol stream.  Everything the host needs comes back as one
small int16 header plus the used prefix of an int16 levels buffer, both by
pinned non-blocking copies behind a recorded CUDA event; the per-frame small
inputs go up as one packed int32 vector.

Every stage is a dense per-size grid over the whole frame with static
shapes: no per-block control flow.  Cells the partition plan did not choose
still compute and are masked out.  The host builders (plan, geometry, aux
layout, decision derivation) are numpy copies of the reference's.

The reference runs the stages as five jitted programs per geometry
(``chain_stages_jit``).  Here :func:`chain_stages` returns the five stage
functions, :func:`run_stages` runs them eagerly, and
``device/graphs.ChainPrograms`` (which :func:`dispatch_chain` takes) runs
them as five CUDA graphs per geometry and CDEF candidate lists on a card.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch

from rav1e_tpu_torch.device import dsp
from rav1e_tpu_torch.device.constants import device_cache
from rav1e_tpu_torch.tx import TxSize, TxType
from rav1e_tpu_torch.utils.trace import span

_I32 = torch.int32

# AV1 ref ids (context/mv.py); device ref index 0/1/2 = LAST/ALTREF/BWDREF
REF_LAST, REF_BWDREF, REF_ALTREF = 1, 5, 7

# device padding of ref/recon planes; MC support reach (mv 80px + 4 + 3)
# must stay inside it, so MVs are clamped to +-MV_CLIP eighth-pels
PADD = 88
MV_CLIP = (PADD - 8) << 3

# block px size -> luma TxSize (MAX_TXSIZE_RECT for square bsizes)
SQ_TX = {8: TxSize.TX_8X8, 16: TxSize.TX_16X16, 32: TxSize.TX_32X32,
         64: TxSize.TX_64X64}
SUB_TX = {TxSize.TX_64X64: TxSize.TX_32X32, TxSize.TX_32X32: TxSize.TX_16X16,
          TxSize.TX_16X16: TxSize.TX_8X8, TxSize.TX_8X8: TxSize.TX_4X4}
# block px -> chroma TxSize at 4:2:0 (largest_chroma_tx_size of the square)
SQ_CTX = {8: TxSize.TX_4X4, 16: TxSize.TX_8X8, 32: TxSize.TX_16X16,
          64: TxSize.TX_32X32}
# square block px -> BlockSize id (partition.py _BS_DIMS order)
SQ_BSIZE = {8: 3, 16: 6, 32: 9, 64: 12}


def tx_for_block(size_px: int, tx_split: bool) -> TxSize:
    t = SQ_TX[size_px]
    return SUB_TX[t] if tx_split else t


# ---------------------------------------------------------------------------
# plan builder (host, vectorised): replicate the native partition walk
# (tile_block.inc encode_partition + quantize_inter_blocks job order) and
# assign a walk ordinal to every tx block.  DFS pre-order of the quadtree
# within a superblock is exactly Morton order of the leaf origins, so the
# whole walk vectorises as one argsort over (sb_raster, morton) keys.
# ---------------------------------------------------------------------------


@dataclass
class ChainPlan:
    mi_cols: int
    mi_rows: int
    tx_split: bool
    n_tx: int = 0
    n_blk: int = 0
    magics: np.ndarray = None       # (n_tx,) i32 native coeff-log magics
    # leaf blocks in walk order
    blk_x8: np.ndarray = None       # (n_blk,) top-left 8px-cell col
    blk_y8: np.ndarray = None
    blk_sl: np.ndarray = None       # (n_blk,) size log2 (3..6)
    # per-bucket walk-ordinal grids: (plane, TxSize) -> (gh, gw) i32, -1
    # inactive.  plane: 0 luma, 1 u, 2 v.  Grids span the SB-aligned extent.
    ords: Dict[tuple, np.ndarray] = field(default_factory=dict)
    eff8: np.ndarray = None         # (nby8, nbx8) chosen size log2 per 8px cell


def effective_size8(size_log2: np.ndarray, mi_cols: int, mi_rows: int,
                    pr_min: int, pr_max: int) -> np.ndarray:
    """The native walk's leaf size per 8px cell (tile_block.inc
    encode_partition, top-down): at each level wl the block splits iff it
    crosses the mi edge (must_split), wl > pr_max, or the clamped device
    size map at its ORIGIN cell asks for something smaller."""
    nby_a = ((mi_rows + 15) // 16) * 8
    nbx_a = ((mi_cols + 15) // 16) * 8
    sz = np.clip(size_log2[:nby_a, :nbx_a], pr_min, pr_max)

    y8, x8 = np.mgrid[0:nby_a, 0:nbx_a]
    eff = np.full((nby_a, nbx_a), 3, dtype=np.int32)
    still = np.ones((nby_a, nbx_a), dtype=bool)  # all ancestors split
    for sl in (6, 5, 4):
        c = 1 << (sl - 3)          # 8px cells per side
        oy, ox = y8 & ~(c - 1), x8 & ~(c - 1)
        hbs = c >> 1               # half extent in 8px cells
        fits = ((ox + hbs) * 2 < mi_cols) & ((oy + hbs) * 2 < mi_rows)
        not_split = (
            fits & (sl <= pr_max) & ((sl <= pr_min) | (sl <= sz[oy, ox]))
        )
        eff = np.where(still & not_split, sl, eff)
        still &= ~not_split
    return eff


def build_plan(size_log2: np.ndarray, mi_cols: int, mi_rows: int,
               pr_min: int, pr_max: int, tx_split: bool) -> ChainPlan:
    """Vectorised walk-order plan for an inter frame (all blocks inter,
    4:2:0).  mi dims are always even (spec 5.9.8 compute_image_size)."""
    assert mi_cols % 2 == 0 and mi_rows % 2 == 0
    plan = ChainPlan(mi_cols, mi_rows, tx_split)
    sb_cols = (mi_cols + 15) // 16
    sb_rows = (mi_rows + 15) // 16
    nby_a, nbx_a = sb_rows * 8, sb_cols * 8

    eff = effective_size8(size_log2, mi_cols, mi_rows, pr_min, pr_max)
    plan.eff8 = eff

    y8, x8 = np.mgrid[0:nby_a, 0:nbx_a]
    c = 1 << (eff - 3)
    # leaf origins with in-mi origin (8px cells beyond the mi grid are not
    # visited: encode_partition returns when x >= mi_w)
    is_origin = ((y8 & (c - 1)) == 0) & ((x8 & (c - 1)) == 0) \
        & (x8 * 2 < mi_cols) & (y8 * 2 < mi_rows)
    oy = y8[is_origin]
    ox = x8[is_origin]
    osl = eff[is_origin]

    # walk order: SB raster, then Morton of the local (y, x) 3-bit coords
    ly, lx = oy & 7, ox & 7
    morton = np.zeros_like(ly)
    for b in range(3):
        morton |= (((ly >> b) & 1) << (2 * b + 1)) | (((lx >> b) & 1) << (2 * b))
    key = ((oy >> 3) * sb_cols + (ox >> 3)) * 64 + morton
    order = np.argsort(key, kind="stable")
    oy, ox, osl = oy[order], ox[order], osl[order]
    n_blk = oy.shape[0]
    plan.n_blk = n_blk
    plan.blk_y8, plan.blk_x8, plan.blk_sl = oy, ox, osl

    # tx blocks per leaf: luma cells (1 or 4 with split, minus mi-clipped
    # ones), then one u and one v cell
    s_px = 1 << osl
    if tx_split:
        # sub-tx cells at pixel offsets (dy, dx) * s/2; clipped when the
        # cell's mi origin crosses the mi grid
        half_px = s_px >> 1
        nl = np.zeros(n_blk, dtype=np.int64)
        for dy in range(2):
            for dx in range(2):
                py = (oy << 3) + dy * half_px
                px = (ox << 3) + dx * half_px
                nl += ((px >> 2 < mi_cols) & (py >> 2 < mi_rows)).astype(
                    np.int64)
    else:
        nl = np.ones(n_blk, dtype=np.int64)
    ntx = nl + 2
    tx0 = np.zeros(n_blk + 1, dtype=np.int64)
    np.cumsum(ntx, out=tx0[1:])
    plan.n_tx = int(tx0[-1])

    magics = np.zeros(plan.n_tx, dtype=np.int32)

    # per-bucket ordinal grids
    def grid(plane: int, t: TxSize) -> np.ndarray:
        keyg = (plane, int(t))
        if keyg not in plan.ords:
            ext_h = sb_rows * (32 if plane else 64)
            ext_w = sb_cols * (32 if plane else 64)
            plan.ords[keyg] = np.full(
                (ext_h // t.height, ext_w // t.width), -1, dtype=np.int32)
        return plan.ords[keyg]

    for sl in (3, 4, 5, 6):
        sel = osl == sl
        if not sel.any():
            continue
        by, bx, b0 = oy[sel], ox[sel], tx0[:-1][sel]
        t = tx_for_block(1 << sl, tx_split)
        g = grid(0, t)
        if tx_split:
            # raster order of the 2x2 sub cells, skipping mi-clipped ones
            half_px = (1 << sl) >> 1
            k = np.zeros_like(b0)
            for dy in range(2):
                for dx in range(2):
                    py = (by << 3) + dy * half_px
                    px = (bx << 3) + dx * half_px
                    ok = (px >> 2 < mi_cols) & (py >> 2 < mi_rows)
                    idx = b0 + k
                    g[py[ok] // t.height, px[ok] // t.width] = idx[ok]
                    magics[idx[ok]] = 0x5A170000 | int(t)
                    k = k + ok.astype(np.int64)
            nl_sel = k
        else:
            g[(by << 3) // t.height, (bx << 3) // t.width] = b0
            magics[b0] = 0x5A170000 | int(t)
            nl_sel = np.ones_like(b0)
        ct = SQ_CTX[1 << sl]
        for p in (1, 2):
            gp = grid(p, ct)
            idx = b0 + nl_sel + (p - 1)
            gp[(by << 2) // ct.height, (bx << 2) // ct.width] = idx
            magics[idx] = 0x5A170000 | (p << 8) | int(ct)
    plan.magics = magics
    return plan


def build_coeff_log(plan: ChainPlan, eobs: np.ndarray,
                    levels: np.ndarray) -> Tuple[np.ndarray, int]:
    """Assemble the native coeff log (magic, eob, levels...) from the device
    outputs.  eobs: (n_tx,) walk-ordered; levels: flat scan-prefix values
    packed by the same walk-order eob cumsum."""
    eobs = eobs.astype(np.int64)
    counts = 2 + eobs
    offs = np.zeros(plan.n_tx + 1, dtype=np.int64)
    np.cumsum(counts, out=offs[1:])
    total = int(offs[-1])
    log = np.zeros(total, dtype=np.int32)
    log[offs[:-1]] = plan.magics
    log[offs[:-1] + 1] = eobs.astype(np.int32)
    lvl_offs = np.zeros(plan.n_tx + 1, dtype=np.int64)
    np.cumsum(eobs, out=lvl_offs[1:])
    n_lvl = int(lvl_offs[-1])
    if n_lvl:
        dst = np.repeat(offs[:-1] + 2, eobs) + (
            np.arange(n_lvl) - np.repeat(lvl_offs[:-1], eobs)
        )
        log[dst] = levels[:n_lvl].astype(np.int32)
    return log.view(np.uint8), total * 4


# ---------------------------------------------------------------------------
# deblock edge decisions on the device (ops/deblock._plane_edge_decisions
# over the chain's mi-granularity grids)
# ---------------------------------------------------------------------------


def _deblock_luts():
    from rav1e_tpu_torch.partition import BlockSize
    lut_txw = np.array([TxSize(t).width >> 2 for t in range(19)],
                       dtype=np.int32)
    lut_txh = np.array([TxSize(t).height >> 2 for t in range(19)],
                       dtype=np.int32)
    lut_n4w = np.array(
        [BlockSize(b).width_mi for b in range(22)], dtype=np.int32)
    lut_n4h = np.array(
        [BlockSize(b).height_mi for b in range(22)], dtype=np.int32)
    return lut_txw, lut_txh, lut_n4w, lut_n4h


@functools.lru_cache(None)
def _chroma_tx_luts(xdec: int, ydec: int):
    from rav1e_tpu_torch.encoder.pipeline import largest_chroma_tx_size
    from rav1e_tpu_torch.partition import BlockSize
    lut_w = np.zeros(22, dtype=np.int32)
    lut_h = np.zeros(22, dtype=np.int32)
    for b in BlockSize:
        if b.width > 64 or b.height > 64:
            continue
        t = largest_chroma_tx_size(b, xdec, ydec)
        lut_w[int(b)] = t.width >> 2
        lut_h[int(b)] = t.height >> 2
    return lut_w, lut_h


@device_cache
def _edge_static(pli: int, xdec: int, ydec: int, rows_p: int, cols_p: int,
                 vertical: bool, mi_rows: int, mi_cols: int, device):
    """The frame-independent index grids and tables of
    :func:`_edge_sizes_device`, on ``device`` once per geometry."""
    lut_txw, lut_txh, lut_n4w, lut_n4h = _deblock_luts()
    jj, ii = np.mgrid[0:rows_p, 0:cols_p]
    ly = np.minimum((jj << ydec) | ydec, mi_rows - 1)
    lx = np.minimum((ii << xdec) | xdec, mi_cols - 1)
    if vertical:
        prev_ly, prev_lx = ly, lx - (1 << xdec)
        pos = ii
        block_pos = ii << xdec
    else:
        prev_ly, prev_lx = ly - (1 << ydec), lx
        pos = jj
        block_pos = jj << ydec
    valid = (prev_lx >= 0) & (prev_ly >= 0)
    if pli == 0:
        tx_w, tx_h = lut_txw, lut_txh
    else:
        tx_w, tx_h = _chroma_tx_luts(xdec, ydec)

    def t(a, dtype=torch.int64):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return {
        "ly": t(ly), "lx": t(lx), "ply": t(np.maximum(prev_ly, 0)),
        "plx": t(np.maximum(prev_lx, 0)), "valid": t(valid, torch.bool),
        "pos": t(pos, _I32), "block_pos": t(block_pos, _I32),
        "tx_n": t(tx_w if vertical else tx_h, _I32),
        "n4": t(lut_n4w if vertical else lut_n4h, _I32),
    }


def _edge_sizes_device(bsize_mi, tx_mi, skip_mi, pli: int, xdec: int,
                       ydec: int, rows_p: int, cols_p: int, vertical: bool,
                       mi_rows: int, mi_cols: int):
    """filter_size per plane-4x4 position (0 = none): the chain's device
    version of ops/deblock._plane_edge_decisions (all blocks inter)."""
    st = _edge_static(pli, xdec, ydec, rows_p, cols_p, vertical, mi_rows,
                      mi_cols, bsize_mi.device)
    ly, lx, ply, plx = st["ly"], st["lx"], st["ply"], st["plx"]
    bsize_g = bsize_mi[ly, lx].long()
    prev_bsize = bsize_mi[ply, plx].long()
    if pli == 0:
        tx_n = st["tx_n"][tx_mi[ly, lx].long()]
        ptx_n = st["tx_n"][tx_mi[ply, plx].long()]
    else:
        tx_n = st["tx_n"][bsize_g]
        ptx_n = st["tx_n"][prev_bsize]
    tx_edge = (st["pos"] & (tx_n - 1)) == 0
    n4 = st["n4"][bsize_g]
    block_edge = (st["block_pos"] & (n4 - 1)) == 0

    skip_g = skip_mi[ly, lx]
    pskip = skip_mi[ply, plx]
    # all-inter frame: the intra terms of the apply mask are False
    apply = block_edge | ~skip_g | ~pskip
    cap = 14 if pli == 0 else 6
    MI_SIZE_LOG2 = 2
    size = torch.clamp(torch.minimum(tx_n, ptx_n) << MI_SIZE_LOG2, max=cap)
    return torch.where(st["valid"] & tx_edge & apply, size, 0)


# ---------------------------------------------------------------------------
# the chain stages (five per inter frame)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ChainGeom:
    """Static geometry + config of a chain dispatch (cache key)."""

    vis_w: int
    vis_h: int
    mi_cols: int
    mi_rows: int
    bd: int
    tx_split: bool
    has_bwd: bool
    has_bwd2: bool
    # buckets in a fixed order: ((plane, tx_id, gh_cells, gw_cells), ...)
    buckets: tuple = ()
    # luma block sizes present: (8, 16, 32, 64) subset
    sizes: tuple = ()

    @property
    def gw(self):
        return ((self.mi_cols + 15) // 16) * 64

    @property
    def gh(self):
        return ((self.mi_rows + 15) // 16) * 64

    @property
    def ntx_cap(self):
        n8 = (self.gh // 8) * (self.gw // 8)
        return (6 if self.tx_split else 3) * n8

    @property
    def lcap(self):
        # levels budget: ~1/3 of the pixel count.  1/8 overflowed on ~40%
        # of bench frames at q=120 (noisy content), and every overflow
        # costs the full chain round-trip PLUS a host-tier re-encode
        return ((self.gh * self.gw * 3 // 2) // 3 + 1023) & ~1023


def edge_leaf_sizes(mi_cols: int, mi_rows: int, pr_min: int,
                    pr_max: int) -> set:
    """Leaf sizes (px) below the partition range that the frame's edges
    force: a block of the range's least size that crosses the mi edge must
    split, down to 8px.  The walk that splits every block it may (a size
    map of ``pr_min`` everywhere) reaches every block of that size, so its
    leaves below ``pr_min`` hold those of any other size map."""
    nby_a = ((mi_rows + 15) // 16) * 8
    nbx_a = ((mi_cols + 15) // 16) * 8
    least = np.full((nby_a, nbx_a), pr_min, dtype=np.int32)
    eff = effective_size8(least, mi_cols, mi_rows, pr_min, pr_max)
    inside = eff[: mi_rows // 2, : mi_cols // 2]
    return {1 << int(sl) for sl in np.unique(inside) if sl < pr_min}


@functools.lru_cache(None)
def geom_for(vis_w, vis_h, mi_cols, mi_rows, bd, tx_split, has_bwd,
             has_bwd2, pr_min, pr_max) -> ChainGeom:
    """Derive the static bucket/size lists: every size of the partition
    range, 8px wherever an mi edge is ragged (the reference's rule), and
    each smaller size that the frame's edges force (:func:`edge_leaf_sizes`:
    the reference's rule alone misses 16px when the range starts at 32, and
    the plan's 16x16 edge leaves would have no bucket)."""
    sb_cols = (mi_cols + 15) // 16
    sb_rows = (mi_rows + 15) // 16
    ragged = (mi_cols % 16 != 0) or (mi_rows % 16 != 0)
    sizes = sorted(
        {s for s in (8, 16, 32, 64)
         if (pr_min <= s.bit_length() - 1 <= pr_max) or (s == 8 and ragged)}
        | edge_leaf_sizes(mi_cols, mi_rows, pr_min, pr_max))
    buckets = []
    for s in sorted(sizes):
        t = tx_for_block(s, tx_split)
        gh_t = sb_rows * 64 // t.height
        gw_t = sb_cols * 64 // t.width
        if (0, int(t), gh_t, gw_t) not in buckets:
            buckets.append((0, int(t), gh_t, gw_t))
    for s in sorted(sizes):
        ct = SQ_CTX[s]
        for p in (1, 2):
            b = (p, int(ct), sb_rows * 32 // ct.height, sb_cols * 32 // ct.width)
            if b not in buckets:
                buckets.append(b)
    return ChainGeom(vis_w, vis_h, mi_cols, mi_rows, bd, tx_split, has_bwd,
                     has_bwd2, tuple(buckets), tuple(sorted(sizes)))


@device_cache
def _clip_index(n: int, pad: int, limit: int, device):
    """clip(arange(n) - pad, 0, limit - 1) on ``device``."""
    return torch.clamp(torch.arange(n, device=device) - pad, 0, limit - 1)


def _pad_edge(plane, vis_h: int, vis_w: int, pad: int):
    """Edge-replicate `plane` (gh, gw) out to (gh+2p, gw+2p), replicating
    from the VISIBLE crop edge (host Plane.pad semantics)."""
    gh, gw = plane.shape
    ry = _clip_index(gh + 2 * pad, pad, vis_h, plane.device)
    rx = _clip_index(gw + 2 * pad, pad, vis_w, plane.device)
    return plane[ry[:, None], rx[None, :]]


def _cells(plane, size_h: int, size_w: int):
    """(gh, gw) -> (N, size_h, size_w) raster cells."""
    gh, gw = plane.shape
    ny, nx = gh // size_h, gw // size_w
    return (plane.reshape(ny, size_h, nx, size_w)
            .permute(0, 2, 1, 3).reshape(ny * nx, size_h, size_w))


def _uncells(cells, gh: int, gw: int, size_h: int, size_w: int):
    ny, nx = gh // size_h, gw // size_w
    return (cells.reshape(ny, nx, size_h, size_w)
            .permute(0, 2, 1, 3).reshape(gh, gw))


def _up(a, k: int):
    """Repeat each element of a 2-D grid into a k x k block."""
    ny, nx = a.shape
    return a[:, None, :, None].expand(ny, k, nx, k).reshape(ny * k, nx * k)


@device_cache
def _field_index(ny: int, nx: int, s: int, ny16: int, nx16: int, device):
    iy = torch.clamp((torch.arange(ny, device=device) * s) // 16, max=ny16 - 1)
    ix = torch.clamp((torch.arange(nx, device=device) * s) // 16, max=nx16 - 1)
    return iy[:, None], ix[None, :]


def _field_at(field, s: int, ny: int, nx: int):
    """MV field (ny16, nx16, 2) -> per size-s cell (top-left 16px cell),
    flattened (N, 2)."""
    iy, ix = _field_index(ny, nx, s, field.shape[0], field.shape[1],
                          field.device)
    return field[iy, ix].reshape(ny * nx, 2)


@device_cache
def _positions(ny: int, nx: int, step: int, device):
    """(pos_y, pos_x): the raster top-left coordinates of an (ny, nx) grid
    of step-px cells, flattened, int32."""
    ar_y = torch.arange(ny, dtype=_I32, device=device) * step
    ar_x = torch.arange(nx, dtype=_I32, device=device) * step
    return (ar_y[:, None].expand(ny, nx).reshape(-1),
            ar_x[None, :].expand(ny, nx).reshape(-1))


def _mc_single(ref_pad, pos_y, pos_x, mv, h, w, bd, xdec, ydec):
    mv_r, mv_c = mv[:, 0], mv[:, 1]
    iy0 = PADD + pos_y + (mv_r >> (3 + ydec)) - 3
    ix0 = PADD + pos_x + (mv_c >> (3 + xdec)) - 3
    win = dsp.mc_gather_windows(ref_pad, iy0, ix0, h, w)
    return dsp.mc_put_from_windows(win, mv_r, mv_c, h, w, bd, xdec, ydec)


def _mc_prep(ref_pad, pos_y, pos_x, mv, h, w, bd, xdec, ydec):
    mv_r, mv_c = mv[:, 0], mv[:, 1]
    iy0 = PADD + pos_y + (mv_r >> (3 + ydec)) - 3
    ix0 = PADD + pos_x + (mv_c >> (3 + xdec)) - 3
    win = dsp.mc_gather_windows(ref_pad, iy0, ix0, h, w)
    return dsp.mc_prep_from_windows(win, mv_r, mv_c, h, w, bd, xdec, ydec)


# candidate order: 0 LAST@field0, 1 ALTREF@field1, 2 BWDREF@field2,
# 3 LAST@zero, 4 compound LAST@field0 + ALTREF@field1
N_CAND = 5
CAND_REF = (0, 1, 2, 0, 0)


@device_cache
def _cand_ref(device):
    return torch.as_tensor(CAND_REF, dtype=_I32, device=device)


def _active_by_size(geom: ChainGeom, ords):
    """Per-size (ny, nx) active-cell masks from the luma bucket ordinals."""
    g = geom
    gh, gw = g.gh, g.gw
    out = {}
    for s in g.sizes:
        t = tx_for_block(s, g.tx_split)
        bi = g.buckets.index((0, int(t), gh // t.height, gw // t.width))
        k2 = 2 if g.tx_split else 1
        out[s] = ords[bi][::k2, ::k2] >= 0
    return out


@functools.lru_cache(None)
def _aux_layout(geom: ChainGeom):
    """Static (offset, length) of each small per-frame input inside the
    single packed i32 ``aux`` upload (one host->device copy per frame
    instead of ~15)."""
    g = geom
    ny16, nx16 = g.gh // 16, g.gw // 16
    nby8, nbx8 = g.gh // 8, g.gw // 8
    offs = {}
    off = 0

    def add(name, n):
        nonlocal off
        offs[name] = (off, n)
        off += n

    add("fields", 3 * ny16 * nx16 * 2)
    for i, (_p, _t, ghc, gwc) in enumerate(g.buckets):
        add(("ord", i), ghc * gwc)
    add("dcq8", 3 * nby8 * nbx8)
    add("acq8", 3 * nby8 * nbx8)
    add("dbl", 4)
    add("cdefy", 4)
    add("cdefuv", 4)
    return offs, off


def pack_aux(geom: ChainGeom, plan: "ChainPlan", fields, dcq8, acq8,
             dbl_levels, cdef_y, cdef_uv) -> np.ndarray:
    """Pack the per-frame small chain inputs into one i32 vector."""
    g = geom
    offs, total = _aux_layout(g)
    out = np.empty(total, np.int32)

    def put(name, arr):
        o, n = offs[name]
        out[o : o + n] = np.asarray(arr, dtype=np.int32).reshape(-1)

    put("fields", fields)
    for i, (p, t, ghc, gwc) in enumerate(g.buckets):
        og = plan.ords.get((p, t))
        if og is None:
            og = np.full((ghc, gwc), -1, dtype=np.int32)
        put(("ord", i), og)
    put("dcq8", dcq8)
    put("acq8", acq8)
    put("dbl", dbl_levels)
    put("cdefy", cdef_y)
    put("cdefuv", cdef_uv)
    return out


def _aux_get(geom: ChainGeom, aux, name, shape):
    o, n = _aux_layout(geom)[0][name]
    return aux[o : o + n].reshape(shape)


def _aux_fields(geom: ChainGeom, aux):
    ny16, nx16 = geom.gh // 16, geom.gw // 16
    return _aux_get(geom, aux, "fields", (3, ny16, nx16, 2))


def _aux_ords(geom: ChainGeom, aux):
    return tuple(
        _aux_get(geom, aux, ("ord", i), (ghc, gwc))
        for i, (_p, _t, ghc, gwc) in enumerate(geom.buckets)
    )


def _sel_luma_stage(geom: ChainGeom):
    """Stage 1: candidate selection + luma MC.  Returns the composed luma
    prediction plane and the per-size selection grids."""
    g = geom
    gh, gw = g.gh, g.gw
    bd = g.bd
    big = 2 ** 30

    def fn(src_y_raw, refs_y, aux):
        fields = _aux_fields(g, aux)
        ords = _aux_ords(g, aux)
        dev = aux.device
        src_y = src_y_raw.to(_I32)
        active_by_size = _active_by_size(g, ords)
        sel_grids = []
        pred_y = torch.zeros((gh, gw), dtype=_I32, device=dev)
        for s in g.sizes:
            ny, nx = gh // s, gw // s
            n = ny * nx
            pos_y, pos_x = _positions(ny, nx, s, dev)
            f = [_field_at(fields[k], s, ny, nx) for k in range(3)]
            zero = torch.zeros((n, 2), dtype=_I32, device=dev)
            cand_mv = [f[0], f[1], f[2], zero, f[0]]

            src_cells = _cells(src_y, s, s)
            preds = []
            sads = []
            for k in range(N_CAND):
                if ((k == 1 and not g.has_bwd) or (k == 2 and not g.has_bwd2)
                        or (k == 4 and not g.has_bwd)):
                    preds.append(preds[0])
                    sads.append(torch.full((n,), big, dtype=_I32, device=dev))
                    continue
                if k == 4:
                    t0 = _mc_prep(refs_y[0], pos_y, pos_x, f[0], s, s, bd, 0, 0)
                    t1 = _mc_prep(refs_y[1], pos_y, pos_x, f[1], s, s, bd, 0, 0)
                    p = dsp.mc_avg(t0, t1, bd)
                    bias = s  # pair penalty ((w+h)/2, native select_inter)
                else:
                    p = _mc_single(refs_y[CAND_REF[k]], pos_y, pos_x,
                                   cand_mv[k], s, s, bd, 0, 0)
                    bias = 0
                preds.append(p)
                sads.append((src_cells - p).abs().sum(dim=(1, 2),
                                                      dtype=_I32) + bias)
            sad_all = torch.stack(sads)  # (K, n)
            # ties take the first minimum, as jnp.argmin does
            sel = torch.argmin(sad_all, dim=0)
            pred_sel = torch.stack(preds)[sel, torch.arange(n, device=dev)]

            active = active_by_size[s]
            mask_px = _up(active, s)
            pred_y = torch.where(mask_px, _uncells(pred_sel, gh, gw, s, s),
                                 pred_y)
            sel_grids.append(torch.where(active, sel.to(_I32).reshape(ny, nx),
                                         0))
        return pred_y, tuple(sel_grids)

    return fn


def _chroma_stage(geom: ChainGeom):
    """Stage 2: chroma MC (4:2:0) from the per-size selection grids."""
    g = geom
    gh, gw = g.gh, g.gw
    ch_h, ch_w = gh // 2, gw // 2
    bd = g.bd

    def fn(refs_u, refs_v, aux, sels):
        fields = _aux_fields(g, aux)
        ords = _aux_ords(g, aux)
        dev = aux.device
        ref_u = torch.stack(refs_u)
        ref_v = torch.stack(refs_v)
        cand_ref = _cand_ref(dev)
        active_by_size = _active_by_size(g, ords)
        pred = {"u": torch.zeros((ch_h, ch_w), dtype=_I32, device=dev),
                "v": torch.zeros((ch_h, ch_w), dtype=_I32, device=dev)}
        for si, s in enumerate(g.sizes):
            sc = s >> 1
            ny, nx = gh // s, gw // s
            n = ny * nx
            pos_y, pos_x = _positions(ny, nx, sc, dev)
            f = [_field_at(fields[k], s, ny, nx) for k in range(3)]
            zero = torch.zeros((n, 2), dtype=_I32, device=dev)
            cand_mv = [f[0], f[1], f[2], zero, f[0]]
            sel = sels[si].reshape(-1).long()
            mv0 = torch.stack(cand_mv)[sel, torch.arange(n, device=dev)]
            comp = sel == 4
            ridx = cand_ref[sel]
            active = active_by_size[s]
            mask_px = _up(active, sc)
            for ref_c, name in ((ref_u, "u"), (ref_v, "v")):
                mv_r, mv_c = mv0[:, 0], mv0[:, 1]
                iy0 = PADD + pos_y + (mv_r >> 4) - 3
                ix0 = PADD + pos_x + (mv_c >> 4) - 3
                win = dsp.mc_gather_windows_ref(ref_c, ridx, iy0, ix0, sc, sc)
                single = dsp.mc_put_from_windows(win, mv_r, mv_c, sc, sc,
                                                 bd, 1, 1)
                if g.has_bwd:
                    t0 = _mc_prep(ref_c[0], pos_y, pos_x, f[0], sc, sc, bd,
                                  1, 1)
                    t1 = _mc_prep(ref_c[1], pos_y, pos_x, f[1], sc, sc, bd,
                                  1, 1)
                    comp_p = dsp.mc_avg(t0, t1, bd)
                    p = torch.where(comp[:, None, None], comp_p, single)
                else:
                    p = single
                placed = _uncells(p, ch_h, ch_w, sc, sc)
                pred[name] = torch.where(mask_px, placed, pred[name])
        return pred["u"], pred["v"]

    return fn


@device_cache
def _q_index(nyt: int, nxt: int, cell_px: int, block_origin: bool, device):
    """Per tx cell, the (row, col) of the 8px quantizer grid it samples."""
    iy = torch.arange(nyt, device=device)
    ix = torch.arange(nxt, device=device)
    if block_origin:
        iy, ix = (iy // 2) * 2, (ix // 2) * 2
    return ((iy * cell_px) // 8)[:, None], ((ix * cell_px) // 8)[None, :]


def _txq_stage(geom: ChainGeom):
    """Stage 3: forward transform + quantize + reconstruct per bucket,
    walk-order level packing, and the block decision grids."""
    g = geom
    gh, gw = g.gh, g.gw
    ch_h, ch_w = gh // 2, gw // 2
    bd = g.bd

    def fn(src, preds, aux):
        from rav1e_tpu_torch.quantize import _scan_u16

        dev = aux.device
        nby8_q, nbx8_q = g.gh // 8, g.gw // 8
        ords = _aux_ords(g, aux)
        dcq8 = _aux_get(g, aux, "dcq8", (3, nby8_q, nbx8_q))
        acq8 = _aux_get(g, aux, "acq8", (3, nby8_q, nbx8_q))

        srcs = {0: src[0].to(_I32), 1: src[1].to(_I32), 2: src[2].to(_I32)}
        predd = {0: preds[0], 1: preds[1], 2: preds[2]}
        exts = {0: (gh, gw), 1: (ch_h, ch_w), 2: (ch_h, ch_w)}
        recons = {0: preds[0], 1: preds[1], 2: preds[2]}

        # slot ntx_cap is a sentinel: inactive cells write their zero eob
        # there (every duplicate index carries the same value) and nothing
        # reads it back
        eob_ord = torch.zeros((g.ntx_cap + 1,), dtype=_I32, device=dev)
        bucket_levels = []
        overflow = torch.zeros((), dtype=_I32, device=dev)
        for bi, (plane, tid, gh_t, gw_t) in enumerate(g.buckets):
            t = TxSize(tid)
            th, tw = t.height, t.width
            ph, pw = exts[plane]
            cell_px = th * (2 if plane else 1)  # cell size in luma px
            res = _cells(srcs[plane] - predd[plane], th, tw)
            coeffs = dsp.fwd_tx_batched(res, t, TxType.DCT_DCT)
            scan = _scan_u16(min(tw, 32), min(th, 32), "default")
            nyt, nxt = ph // th, pw // tw
            # segmentation qi is a PER-BLOCK property (the coder quantizes
            # every tx cell with the block-origin seg id, tile_block.inc
            # quantize_inter_blocks): with tx_split each luma block spans
            # 2x2 tx cells, so floor the cell index to the block origin
            qy, qx = _q_index(nyt, nxt, cell_px, plane == 0 and g.tx_split,
                              dev)
            dcq = dcq8[plane][qy, qx].reshape(-1)
            acq = acq8[plane][qy, qx].reshape(-1)
            levels, eob = dsp.quantize_batched(coeffs, t, scan, dcq, acq,
                                               False)
            o = ords[bi].reshape(-1)
            active = o >= 0
            eob = torch.where(active, eob, 0)
            slot = torch.where(active, o, g.ntx_cap).long()
            eob_ord.index_put_((slot,), eob)
            overflow = overflow | (
                torch.where(active[:, None], levels.abs(), 0) > 32767
            ).any().to(_I32)
            bucket_levels.append((plane, t, levels, eob, active, slot))

            qdense = dsp.scan_to_dense(levels, t, scan)
            rec_cells = dsp.itx_add_batched(
                qdense, _cells(predd[plane], th, tw), t, TxType.DCT_DCT, bd,
                dcq, acq)
            mask_px = _up(active.reshape(nyt, nxt), th)
            recons[plane] = torch.where(mask_px,
                                        _uncells(rec_cells, ph, pw, th, tw),
                                        recons[plane])

        offs = torch.zeros((g.ntx_cap + 1,), dtype=torch.int64, device=dev)
        offs[1:] = torch.cumsum(eob_ord[: g.ntx_cap], dim=0)
        total_lvl = offs[-1]
        overflow = overflow | (total_lvl > g.lcap).to(_I32)
        # slot lcap is the same kind of sentinel for the levels
        levels_flat = torch.zeros((g.lcap + 1,), dtype=_I32, device=dev)
        for (plane, t, levels, eob, active, slot) in bucket_levels:
            area = levels.shape[1]
            j = torch.arange(area, dtype=torch.int64, device=dev)[None, :]
            dst = offs[slot][:, None] + j
            ok = active[:, None] & (j < eob[:, None]) & (dst < g.lcap)
            dst = torch.where(ok, dst, g.lcap)
            levels_flat.index_put_((dst.reshape(-1),),
                                   torch.where(ok, levels, 0).reshape(-1))

        # ---- block grids (skip, tx size, bsize) -------------------------
        nby8, nbx8 = gh // 8, gw // 8
        nz8 = torch.zeros((nby8, nbx8), dtype=_I32, device=dev)
        for (plane, t, levels, eob, active, slot) in bucket_levels:
            th, tw = t.height, t.width
            ph, pw = exts[plane]
            nyt, nxt = ph // th, pw // tw
            nzg = (eob > 0).to(_I32).reshape(nyt, nxt)
            cell_px = th * (2 if plane else 1)
            if cell_px >= 8:
                nz8 = nz8 + _up(nzg, cell_px // 8)
            else:
                # sub-8px tx cells (tx_split on 8px blocks): pool 2x2
                k = 8 // cell_px
                nz8 = nz8 + nzg.reshape(nyt // k, k, nxt // k, k).sum(
                    dim=(1, 3), dtype=_I32)

        active_by_size = _active_by_size(g, ords)
        skip8 = torch.zeros((nby8, nbx8), dtype=_I32, device=dev)
        tx8 = torch.zeros((nby8, nbx8), dtype=_I32, device=dev)
        bsize8 = torch.zeros((nby8, nbx8), dtype=_I32, device=dev)
        for s in g.sizes:
            c8 = s // 8
            ny, nx = gh // s, gw // s
            blk_nz = nz8.reshape(ny, c8, nx, c8).sum(dim=(1, 3), dtype=_I32)
            blk_skip = (blk_nz == 0).to(_I32)
            active = active_by_size[s].to(_I32)
            up = _up(blk_skip * active, c8)
            upa = _up(active, c8) > 0
            skip8 = torch.where(upa, up, skip8)
            max_tx = int(SQ_TX[s])
            cho_tx = int(tx_for_block(s, g.tx_split))
            tx_val = torch.where(blk_skip > 0, max_tx, cho_tx).to(_I32)
            tx8 = torch.where(upa, _up(tx_val, c8), tx8)
            bsize8 = torch.where(upa, SQ_BSIZE[s], bsize8)

        return (levels_flat, eob_ord, overflow,
                (recons[0], recons[1], recons[2]), skip8, tx8, bsize8)

    return fn


def _filters_stage(geom: ChainGeom):
    """Stage 4: deblock + CDEF on the reconstruction; emits the padded
    reference planes for the next frames and the per-SB cdef indices.

    The CDEF candidate strength lists ``y_list``/``uv_list`` come as host
    ints (the port's ``cdef_stage_core`` branches on them); the same lists
    travel in ``aux`` as the reference packs them."""
    g = geom
    gh, gw = g.gh, g.gw
    ch_h, ch_w = gh // 2, gw // 2
    bd = g.bd

    def fn(recons, src, skip8, tx8, bsize8, aux, y_list, uv_list):
        from rav1e_tpu_torch.device.filters import cdef_stage_core

        dev = aux.device
        dbl_levels = _aux_get(g, aux, "dbl", (4,))
        srcs = {0: src[0].to(_I32), 1: src[1].to(_I32), 2: src[2].to(_I32)}
        exts = {0: (gh, gw), 1: (ch_h, ch_w), 2: (ch_h, ch_w)}

        # mi-granularity grids for the deblock decisions
        skip_mi = _up(skip8.to(torch.bool), 2)
        tx_mi = _up(tx8, 2)
        bsize_mi = _up(bsize8, 2)

        # ---- deblock ----------------------------------------------------
        planes_rec = [recons[0], recons[1], recons[2]]
        for pli in range(3):
            xdec = 0 if pli == 0 else 1
            ydec = xdec
            ph, pw = exts[pli]
            pw_c = (g.vis_w + xdec) >> xdec
            ph_c = (g.vis_h + ydec) >> ydec
            cols_p = min((pw_c + 3) >> 2, (g.mi_cols + xdec) >> xdec)
            rows_p = min((ph_c + 3) >> 2, (g.mi_rows + ydec) >> ydec)
            rec_p = torch.nn.functional.pad(planes_rec[pli], (8, 8, 8, 8))
            for vertical in (True, False):
                level = (dbl_levels[0 if vertical else 1] if pli == 0
                         else dbl_levels[pli + 1])
                sizes = _edge_sizes_device(
                    bsize_mi, tx_mi, skip_mi, pli, xdec, ydec, rows_p,
                    cols_p, vertical, g.mi_rows, g.mi_cols)
                if vertical:
                    sizes[:, 0].zero_()
                else:
                    sizes[0, :].zero_()
                full = torch.zeros((ph // 4, pw // 4), dtype=_I32, device=dev)
                full[:rows_p, :cols_p] = sizes
                full = torch.where(level > 0, full, 0)
                rec_p = dsp.deblock_pass_device(rec_p, full, level, bd,
                                                vertical)
            planes_rec[pli] = rec_p[8:-8, 8:-8]

        # ---- CDEF -------------------------------------------------------
        nby_c = g.mi_rows // 2
        nbx_c = g.mi_cols // 2
        sb_rows = (g.vis_h + 63) // 64
        sb_cols = (g.vis_w + 63) // 64
        planes_geom = []
        rec_grids = []
        src_grids = []
        for pli in range(3):
            xd = 0 if pli == 0 else 1
            yd = xd
            ys, xs = 8 >> yd, 8 >> xd
            vh = (g.vis_h + (1 << yd) - 1) >> yd
            vw = (g.vis_w + (1 << xd) - 1) >> xd
            planes_geom.append((ys, xs, vh, vw))
            p = planes_rec[pli]
            gh_c, gw_c = nby_c * ys, nbx_c * xs
            ry = _clip_index(gh_c + 4, 2, p.shape[0], dev)
            rx = _clip_index(gw_c + 4, 2, p.shape[1], dev)
            rec_grids.append(p[ry[:, None], rx[None, :]])
            src_grids.append(srcs[pli][:gh_c, :gw_c])

        filt = skip8[:nby_c, :nbx_c] == 0
        outs, cdef_idx = cdef_stage_core(
            planes_geom, (nby_c, nbx_c, sb_rows, sb_cols, g.vis_w, g.vis_h),
            3, bd, rec_grids, src_grids, filt, list(y_list), list(uv_list))
        for pli in range(3):
            ys, xs, vh, vw = planes_geom[pli]
            gh_c, gw_c = nby_c * ys, nbx_c * xs
            # planes_rec[pli] views the deblock's own output, not an input
            planes_rec[pli][:gh_c, :gw_c] = outs[pli].to(_I32)

        # ---- final padded recon (next frames' reference) ----------------
        out_dt = torch.uint8 if bd == 8 else torch.int32
        ref_out = []
        for pli in range(3):
            xd = 0 if pli == 0 else 1
            vh = (g.vis_h + (1 << xd) - 1) >> xd
            vw = (g.vis_w + (1 << xd) - 1) >> xd
            ref_out.append(
                _pad_edge(planes_rec[pli], vh, vw, PADD).to(out_dt))
        return tuple(ref_out), cdef_idx.to(_I32)

    return fn


def _pack_stage(geom: ChainGeom):
    """Stage 5: assemble the host payload as an (header, levels) int16 pair.

    The header (overflow flag, walk-order eobs, selection grids, cdef
    indices) is small and always downloaded whole; the levels buffer is
    lcap-sized but only ``sum(eobs)`` entries are meaningful, so the fetch
    side downloads just that prefix."""
    g = geom

    def fn(overflow, eob_ord, sels, cdef_idx, levels_flat):
        parts = [overflow[None].to(torch.int16),
                 eob_ord[: g.ntx_cap].to(torch.int16)]
        for sg in sels:
            parts.append(sg.reshape(-1).to(torch.int16))
        parts.append(cdef_idx.reshape(-1).to(torch.int16))
        return torch.cat(parts), levels_flat[: g.lcap].to(torch.int16)

    return fn


@functools.lru_cache(None)
def chain_stages(geom: ChainGeom):
    """The five stage functions of the chain for one geometry: select +
    luma MC, chroma MC, transform/quantize/recon, deblock + CDEF, pack.
    They hold no tensors, so every pipeline may share them; the graphs'
    static buffers are each pipeline's own (``graphs.ChainPrograms``)."""
    return (
        _sel_luma_stage(geom),
        _chroma_stage(geom),
        _txq_stage(geom),
        _filters_stage(geom),
        _pack_stage(geom),
    )


# ---------------------------------------------------------------------------
# host-side runner: slot state, dispatch, fetch, decision derivation
# ---------------------------------------------------------------------------


@dataclass
class ChainResult:
    eobs: np.ndarray          # (n_tx,) i32 walk-ordered
    levels: np.ndarray        # flat i32 scan-prefix values (walk-order packed)
    sel: Dict[int, np.ndarray]  # size -> (ny, nx) i16 candidate per cell
    cdef_idx: np.ndarray      # (sb_rows, sb_cols) i32
    overflow: bool
    refs: tuple = None        # (y, u, v) padded device recon planes


def host_pad_planes(frame, vis_w: int, vis_h: int):
    """Host Frame -> the chain's padded device layout (list of 3 numpy
    planes, SB-extent + PADD edge padding, native dtype)."""
    sb_cols = ((vis_w + 7) // 8 * 8 + 63) // 64
    sb_rows = ((vis_h + 7) // 8 * 8 + 63) // 64
    out = []
    for pli in range(3):
        pl = frame.planes[pli]
        xd, yd = pl.cfg.xdec, pl.cfg.ydec
        vw = (vis_w + xd) >> xd
        vh = (vis_h + yd) >> yd
        gw = sb_cols * (64 >> xd)
        gh = sb_rows * (64 >> yd)
        pad = pl.cfg.pad
        vis = pl.data[pad : pad + vh, pad : pad + vw]
        ry = np.clip(np.arange(gh + 2 * PADD) - PADD, 0, vh - 1)
        rx = np.clip(np.arange(gw + 2 * PADD) - PADD, 0, vw - 1)
        out.append(np.ascontiguousarray(vis[ry[:, None], rx[None, :]]))
    return out


def host_src_planes(frame, vis_w: int, vis_h: int):
    """Host Frame -> SB-extent source planes (native dtype, no pad)."""
    sb_cols = ((vis_w + 7) // 8 * 8 + 63) // 64
    sb_rows = ((vis_h + 7) // 8 * 8 + 63) // 64
    out = []
    for pli in range(3):
        pl = frame.planes[pli]
        xd, yd = pl.cfg.xdec, pl.cfg.ydec
        vw = (vis_w + xd) >> xd
        vh = (vis_h + yd) >> yd
        gw = sb_cols * (64 >> xd)
        gh = sb_rows * (64 >> yd)
        pad = pl.cfg.pad
        # include the plane's own edge padding out to the SB extent
        sl = pl.data[pad : pad + gh, pad : pad + gw]
        if sl.shape == (gh, gw):
            out.append(np.ascontiguousarray(sl))
        else:
            vis = pl.data[pad : pad + vh, pad : pad + vw]
            ry = np.clip(np.arange(gh), 0, vh - 1)
            rx = np.clip(np.arange(gw), 0, vw - 1)
            out.append(np.ascontiguousarray(vis[ry[:, None], rx[None, :]]))
    return out


def clamp_fields(maps, ny16: int, nx16: int):
    """Pack + clamp the analysis MV fields -> (3, ny16, nx16, 2) i32."""
    out = np.zeros((3, ny16, nx16, 2), dtype=np.int32)
    for k, f in enumerate((maps.mv0, maps.mv1, maps.mv2)):
        if f is not None:
            out[k] = np.clip(f[:ny16, :nx16], -MV_CLIP, MV_CLIP)
    return out


def to_device(a, device, dtype=None) -> torch.Tensor:
    """A host numpy array on ``device``: through pinned memory and a
    non-blocking copy on a CUDA device (the caching host allocator keeps the
    pinned buffer until the copy has run), as is on the CPU.  Tensors pass
    through."""
    if isinstance(a, torch.Tensor):
        return a if dtype is None else a.to(dtype)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype is not None:
        t = t.to(dtype)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def stage_calls(geom: ChainGeom, y_list, uv_list):
    """The five stages as ``(output names, call)`` pairs.  Each call takes
    a dict holding the inputs ``src`` (y, u, v), ``refs`` ((y, u, v),) * 3
    and ``aux`` and the named outputs of the stages before it, and returns
    its own outputs in the order of its names."""
    f_sel, f_chroma, f_txq, f_filters, f_pack = chain_stages(geom)
    return (
        (("pred_y", "sels"),
         lambda d: f_sel(d["src"][0], tuple(r[0] for r in d["refs"]),
                         d["aux"])),
        (("pred_u", "pred_v"),
         lambda d: f_chroma(tuple(r[1] for r in d["refs"]),
                            tuple(r[2] for r in d["refs"]), d["aux"],
                            d["sels"])),
        (("levels_flat", "eob_ord", "overflow", "recons", "skip8", "tx8",
          "bsize8"),
         lambda d: f_txq(d["src"], (d["pred_y"], d["pred_u"], d["pred_v"]),
                         d["aux"])),
        (("ref_out", "cdef_idx"),
         lambda d: f_filters(d["recons"], d["src"], d["skip8"], d["tx8"],
                             d["bsize8"], d["aux"], y_list, uv_list)),
        (("hdr", "levels"),
         lambda d: f_pack(d["overflow"], d["eob_ord"], d["sels"],
                          d["cdef_idx"], d["levels_flat"])),
    )


def run_stages(geom: ChainGeom, src, refs, aux, y_list, uv_list):
    """The five stages, eagerly, on device tensors: src (y, u, v) SB-extent
    planes, refs ((y, u, v),) * 3 padded reference planes, aux the packed
    int32 inputs.  Returns (ref_out, hdr, levels): the padded recon planes
    and the int16 payload pair."""
    d = {"src": src, "refs": refs, "aux": aux}
    for names, call in stage_calls(geom, y_list, uv_list):
        d.update(zip(names, call(d)))
    return d["ref_out"], d["hdr"], d["levels"]


# previous frame's level count per geometry: sizes the optimistic levels
# prefix download (frames are temporally coherent, so last frame's total
# predicts this one's within the 1.5x slack nearly always)
_LVL_TOTAL_HINT: Dict[ChainGeom, int] = {}


def _lvl_bucket(n: int, cap: int) -> int:
    """Round a levels prefix length up to an 8K bucket."""
    return min((max(int(n), 1) + 8191) & ~8191, cap)


def _download(t: torch.Tensor) -> torch.Tensor:
    """Start a device->host copy of ``t`` into pinned memory (non-blocking
    on a CUDA device); the result is valid once the stream reaches it.  On
    the CPU a copy too: ``t`` may be a static buffer of the runner, which
    the next dispatch overwrites."""
    if t.device.type != "cuda":
        return t.clone()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def dispatch_chain(programs, geom: ChainGeom, plan: ChainPlan, src_planes,
                   ref_planes, fields, dcq8, acq8, dbl_levels, cdef_y,
                   cdef_uv):
    """Launch the chain through ``programs`` (a ``graphs.ChainPrograms``,
    which names the device).

    src_planes: 3 SB-extent planes (numpy, or the luma already on the
    device); ref_planes: ((y, u, v),) * 3 padded planes on the device;
    fields: (3, ny16, nx16, 2) i32; cdef_y/cdef_uv: the candidate strength
    lists.  Everything is enqueued on the current stream, and the header and
    an optimistic levels prefix start their way to the host right behind it.
    Returns an opaque handle for :func:`fetch_chain`."""
    # ONE host->device transfer for everything but the pixel planes
    aux = pack_aux(geom, plan, fields, dcq8, acq8, dbl_levels, cdef_y,
                   cdef_uv)
    ref_out, hdr, levels = programs.run(geom, src_planes, ref_planes, aux,
                                        cdef_y, cdef_uv)
    pre_n = _lvl_bucket(_LVL_TOTAL_HINT.get(geom, 8192) * 3 // 2, geom.lcap)
    hdr_host = _download(hdr)
    pre_host = _download(levels[:pre_n])
    ready = None
    if hdr.device.type == "cuda":
        ready = torch.cuda.Event()
        ready.record()
    return (geom, plan, ref_out, (hdr_host, pre_host, levels, ready))


def fetch_chain(handle) -> ChainResult:
    geom, plan, ref_out, (hdr_host, pre_host, lvl_dev, ready) = handle
    g = geom
    with span("chain_wait_ready"):
        if ready is not None:
            ready.synchronize()
    arr = hdr_host.numpy()
    off = 0
    overflow = bool(arr[0])
    off += 1
    eobs_all = arr[off : off + g.ntx_cap]
    eobs = eobs_all[: plan.n_tx].astype(np.int32)
    off += g.ntx_cap
    sel = {}
    for s in g.sizes:
        ny, nx = g.gh // s, g.gw // s
        sel[s] = arr[off : off + ny * nx].reshape(ny, nx)
        off += ny * nx
    sb_rows = (g.vis_h + 63) // 64
    sb_cols = (g.vis_w + 63) // 64
    cdef_idx = arr[off : off + sb_rows * sb_cols].reshape(
        sb_rows, sb_cols).astype(np.int32)

    total = int(eobs_all.astype(np.int64).sum())
    _LVL_TOTAL_HINT[g] = total
    need = min(total, g.lcap)
    with span("chain_download_levels"):
        if need <= pre_host.shape[0]:
            lv = pre_host[:need].numpy()
        else:
            lv = lvl_dev[: _lvl_bucket(need, g.lcap)].cpu().numpy()[:need]
    levels = lv.astype(np.int32)
    return ChainResult(eobs, levels, sel, cdef_idx, overflow, ref_out)


# AV1 ref-type codes per candidate (device index 0/1/2 = LAST/ALTREF/BWDREF)
CAND_REF_TYPE = np.array([REF_LAST, REF_ALTREF, REF_BWDREF, REF_LAST,
                          REF_LAST], dtype=np.int8)


def derive_decisions(geom: ChainGeom, plan: ChainPlan, sel: Dict[int, np.ndarray],
                     fields: np.ndarray):
    """Chain decisions -> the native coder's reuse grids (mi granularity):
    (is_inter u8, ref i8 (.., 2), mv i16 (.., 4)).  Must mirror the device
    stages' candidate->mv mapping exactly."""
    g = geom
    mi_rows, mi_cols = g.mi_rows, g.mi_cols
    is_inter = np.ones((mi_rows, mi_cols), dtype=np.uint8)
    ref = np.zeros((mi_rows, mi_cols, 2), dtype=np.int8)
    mv = np.zeros((mi_rows, mi_cols, 4), dtype=np.int16)
    ny16, nx16 = fields.shape[1], fields.shape[2]

    for s in g.sizes:
        t = tx_for_block(s, g.tx_split)
        og = plan.ords.get((0, int(t)))
        if og is None:
            continue
        k2 = 2 if g.tx_split else 1
        active = og[::k2, ::k2] >= 0
        ny, nx = g.gh // s, g.gw // s
        sg = np.asarray(sel[s], dtype=np.int64)
        # top-left 16px cell of each size-s cell (must match _field_at)
        fy = np.minimum(np.arange(ny) * s // 16, ny16 - 1)
        fx = np.minimum(np.arange(nx) * s // 16, nx16 - 1)
        f0 = fields[0][fy[:, None], fx[None, :]]
        f1 = fields[1][fy[:, None], fx[None, :]]
        f2 = fields[2][fy[:, None], fx[None, :]]
        zero = np.zeros_like(f0)
        mv0 = np.choose(sg[..., None], [f0, f1, f2, zero, f0])
        mv1 = np.where((sg == 4)[..., None], f1, 0)
        rt = CAND_REF_TYPE[sg]
        r2 = np.where(sg == 4, np.int8(REF_ALTREF), np.int8(-1))

        c = s // 4  # mi cells per side
        rep = lambda a: np.repeat(np.repeat(a, c, axis=0), c, axis=1)  # noqa: E731
        am = rep(active)[:mi_rows, :mi_cols]
        ref[..., 0] = np.where(am, rep(rt)[:mi_rows, :mi_cols], ref[..., 0])
        ref[..., 1] = np.where(am, rep(r2)[:mi_rows, :mi_cols], ref[..., 1])
        for i in range(2):
            mv[..., i] = np.where(
                am, rep(mv0[..., i])[:mi_rows, :mi_cols], mv[..., i])
            mv[..., 2 + i] = np.where(
                am, rep(mv1[..., i])[:mi_rows, :mi_cols], mv[..., 2 + i])
    return is_inter, ref, mv


class DeviceReconFrame:
    """A Frame whose planes live on the device (the chain's recon) and
    materialise on first host access.  The device layout (SB extent +
    PADD=88 edge padding) is a superset of the host Plane layout (visible +
    PLANE_PADDING=88), so materialisation is a slice."""

    def __init__(self, dev_planes, width: int, height: int, cs, bd: int):
        self._dev = dev_planes
        self._w, self._h, self._cs, self._bd = width, height, cs, bd
        self._frame = None

    def _materialize(self):
        if self._frame is None:
            from rav1e_tpu_torch.frame import Frame

            f = Frame.new(self._w, self._h, self._cs, self._bd)
            with span("recon_download"):
                for pli, pl in enumerate(f.planes):
                    arr = self._dev[pli].cpu().numpy()
                    pl.data[:, :] = arr[: pl.data.shape[0],
                                        : pl.data.shape[1]]
            self._frame = f
        return self._frame

    @property
    def planes(self):
        return self._materialize().planes

    def pad(self) -> None:  # device layout is already edge-padded
        pass

    def device_planes(self):
        return self._dev
