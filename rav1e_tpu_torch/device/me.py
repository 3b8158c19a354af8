"""Device motion estimation: the whole-frame pyramid search on tensors.

Counterpart of ``rav1e_tpu/device/me.py`` (and of ``device/dsp.py`` for the
window gather).  Every level evaluates a fixed candidate grid around its seed
for every block at once: each full-pel round is one :func:`kernels.grid_search`
kernel (window gather, SADs and argmin), then a 7x7 eighth-pel grid with
exact 8-tap REGULAR interpolation is scored through the :func:`kernels.satd8`
kernel.

Levels: L2 quarter-res (step-2 R=3, then step-1 R=1), L1 half-res (R=2, two
seeds), L0 full-res (R=2, two seeds), then subpel.  Output: per-16x16-cell
MVs in 1/8-pel units.  Ties break toward the earlier seed and the shorter
offset (``torch.argmin`` returns the first minimum, as ``jnp.argmin`` does).
"""

from __future__ import annotations

import functools

import torch

from rav1e_tpu_torch.ops.mc import SUBPEL_FILTERS
from rav1e_tpu_torch.device import kernels
from rav1e_tpu_torch.device.constants import (
    L0_CLIP,
    L1_CLIP,
    L2_CLIP,
    ME_BLOCK,
    PAD_L0,
    PAD_L1,
    PAD_L2,
    SUBPEL_OFFS,
    subpel_variants,
)

_I32 = torch.int32


def _pool2(a):
    """2x2 mean pool with floor division (downsample one pyramid level)."""
    h2 = (a.shape[0] // 2) * 2
    w2 = (a.shape[1] // 2) * 2
    b = a[:h2, :w2]
    return (b[0::2, 0::2] + b[0::2, 1::2] + b[1::2, 0::2] + b[1::2, 1::2]) // 4


def _blockify(plane, blk):
    ny, nx = plane.shape[0] // blk, plane.shape[1] // blk
    return (
        plane[: ny * blk, : nx * blk]
        .reshape(ny, blk, nx, blk)
        .permute(0, 2, 1, 3)
        .reshape(-1, blk, blk)
    ), ny, nx


def _pad_edge(a, p: int):
    """Replicate-pad a 2-D integer plane by p on every side."""
    H, W = a.shape
    ry = torch.arange(-p, H + p, device=a.device).clamp_(0, H - 1)
    rx = torch.arange(-p, W + p, device=a.device).clamp_(0, W - 1)
    return a[ry[:, None], rx[None, :]]


def _grid_search(src_blocks, ref_pad, base_y, base_x, seeds, blk, R, step,
                 pad_off, clip_mv):
    """One full-pel candidate-grid round for every block at once, through
    the grid_search kernel (kernels.grid_search_plain says what it
    computes).  Returns the updated (n, 2) int32 MVs."""
    return kernels.grid_search(src_blocks, ref_pad, base_y, base_x, seeds,
                               blk, R, step, pad_off, clip_mv)


def _up2_mvs(mv, ny, nx):
    """Double a coarser MV grid (x2 px) and repeat onto the finer grid."""
    cy, cx = mv.shape[0], mv.shape[1]
    up = (mv * 2).repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
    ys = torch.arange(ny, device=mv.device).clamp(max=2 * cy - 1)
    xs = torch.arange(nx, device=mv.device).clamp(max=2 * cx - 1)
    return up[ys[:, None], xs[None, :]]


def _hadamard16_satd(diff):
    """SATD of (n, k, 16, 16) int32 diffs over 8x8 Hadamard cells -> (n, k)
    f32, through the satd8 kernel."""
    return kernels.satd8(diff)


@functools.lru_cache(None)
def _subpel_tables(device):
    pen = torch.tensor(
        [abs(oy) + abs(ox) for oy in SUBPEL_OFFS for ox in SUBPEL_OFFS],
        dtype=torch.float32, device=device,
    )
    off = torch.tensor(
        [[oy, ox] for oy in SUBPEL_OFFS for ox in SUBPEL_OFFS],
        dtype=_I32, device=device,
    )
    return pen, off


def _subpel_refine(src_blocks, ref_pad, base_y, base_x, mv_full, pad_off,
                   clip_mv, bd):
    """7x7 eighth-pel SATD refinement around per-block full-pel MVs.

    Interpolation matches ops/mc.put_8tap bit-exactly (REGULAR filters,
    intermediate >> (7-IB) with rounding, final >> (7+IB), clamp).
    Returns (n, 2) int32 MVs in 1/8-pel units.
    """
    blk = src_blocks.shape[1]
    IB = 4 - (2 if bd == 12 else 0)
    maxval = (1 << bd) - 1
    filt = SUBPEL_FILTERS[0]  # REGULAR, Q7

    my = mv_full[:, 0].clamp(-clip_mv, clip_mv)
    mx = mv_full[:, 1].clamp(-clip_mv, clip_mv)
    # window rows/cols -4 .. blk+4 (int shift -1..0, taps -3..+4)
    W = blk + 9
    ty = base_y + my - 4 + pad_off
    tx = base_x + mx - 4 + pad_off
    win = kernels.gather_windows(ref_pad, ty, tx, W)  # (n, W, W) int32

    variants = subpel_variants()
    # horizontal pass per column variant: (n, W, blk) int32
    hbufs = []
    for ci, cf in variants:
        if cf == 0:
            hb = win[:, :, 4 + ci : 4 + ci + blk] << IB
        else:
            f = filt[cf]
            x0 = 4 + ci - 3
            acc = None
            for k in range(8):
                t = int(f[k])
                if t == 0:
                    continue
                v = win[:, :, x0 + k : x0 + k + blk] * t
                acc = v if acc is None else acc + v
            hb = (acc + (1 << (6 - IB))) >> (7 - IB)
        hbufs.append(hb)

    preds = []
    for ri, rf in variants:
        for hb in hbufs:
            if rf == 0:
                p = (hb[:, 4 + ri : 4 + ri + blk, :] + (1 << IB >> 1)) >> IB
            else:
                f = filt[rf]
                y0 = 4 + ri - 3
                acc = None
                for k in range(8):
                    t = int(f[k])
                    if t == 0:
                        continue
                    v = hb[:, y0 + k : y0 + k + blk, :] * t
                    acc = v if acc is None else acc + v
                sh = 7 + IB
                p = (acc + (1 << sh >> 1)) >> sh
            preds.append(p.clamp(0, maxval))
    P = torch.stack(preds, dim=1)  # (n, 49, blk, blk); index = oy*7 + ox
    diffs = src_blocks[:, None] - P
    satd = _hadamard16_satd(diffs)  # (n, 49) float32
    pen, off = _subpel_tables(src_blocks.device)
    # deterministic tie-break toward the shorter offset
    k = torch.argmin(satd * 64.0 + pen, dim=1)
    sel = off[k]  # (n, 2)
    return torch.stack([my * 8, mx * 8], dim=-1) + sel


def _block_bases(ny, nx, device):
    by = (torch.arange(ny, dtype=_I32, device=device) * ME_BLOCK)[:, None]
    bx = (torch.arange(nx, dtype=_I32, device=device) * ME_BLOCK)[None, :]
    return (by.expand(ny, nx).reshape(-1), bx.expand(ny, nx).reshape(-1))


def me_field(luma, ref, bd: int):
    """Whole-frame device ME: (H, W) int32 planes (64-multiple dims) ->
    (H/16, W/16, 2) int32 MVs in 1/8-pel units."""
    dev = luma.device
    l1s, l1r = _pool2(luma), _pool2(ref)
    l2s, l2r = _pool2(l1s), _pool2(l1r)

    # L2: quarter res, blocks of 16 (64px full-res granularity)
    s2, ny2, nx2 = _blockify(l2s, ME_BLOCK)
    base_y2, base_x2 = _block_bases(ny2, nx2, dev)
    r2p = _pad_edge(l2r, PAD_L2)
    mv = torch.zeros((ny2 * nx2, 2), dtype=_I32, device=dev)
    mv = _grid_search(s2, r2p, base_y2, base_x2, [mv], ME_BLOCK, 3, 2,
                      PAD_L2, L2_CLIP)
    mv = _grid_search(s2, r2p, base_y2, base_x2, [mv], ME_BLOCK, 1, 1,
                      PAD_L2, L2_CLIP)
    mv2 = mv.reshape(ny2, nx2, 2)

    # L1: half res
    s1, ny1, nx1 = _blockify(l1s, ME_BLOCK)
    seed1 = _up2_mvs(mv2, ny1, nx1).reshape(-1, 2)
    base_y1, base_x1 = _block_bases(ny1, nx1, dev)
    r1p = _pad_edge(l1r, PAD_L1)
    mv1 = _grid_search(s1, r1p, base_y1, base_x1,
                       [seed1, torch.zeros_like(seed1)], ME_BLOCK, 2, 1,
                       PAD_L1, L1_CLIP).reshape(ny1, nx1, 2)

    # L0: full res
    s0, ny0, nx0 = _blockify(luma, ME_BLOCK)
    seed0 = _up2_mvs(mv1, ny0, nx0).reshape(-1, 2)
    base_y0, base_x0 = _block_bases(ny0, nx0, dev)
    r0p = _pad_edge(ref, PAD_L0)
    mv0 = _grid_search(s0, r0p, base_y0, base_x0,
                       [seed0, torch.zeros_like(seed0)], ME_BLOCK, 2, 1,
                       PAD_L0, L0_CLIP)

    mv8 = _subpel_refine(s0, r0p, base_y0, base_x0, mv0, PAD_L0, L0_CLIP, bd)
    return mv8.reshape(ny0, nx0, 2)
