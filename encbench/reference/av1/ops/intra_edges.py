"""Intra edge buffer construction from the reconstruction plane.

Counterpart of the reference's ``get_intra_edges`` (partition.rs:639-897):
builds the above/left/top-left edge arrays for one tx block, applying the
spec availability rules (frame/tile boundaries, top-right / bottom-left
coding-order availability) and fill values.  Shared verbatim by the encoder
reconstruction path and the bundled verification decoder, which guarantees
both sides predict from identical edges.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from encbench.reference.av1.ops.availability import has_bottom_left, has_top_right
from encbench.reference.av1.ops.intra import IntraEdge
from encbench.reference.av1.partition import (
    BlockSize,
    PredictionMode,
    intra_mode_to_angle,
    supersample_chroma_bsize,
    ANGLE_STEP,
)
from encbench.reference.av1.tx import TxSize


def build_intra_edge(
    rec: np.ndarray,  # tile-origin recon view (plane units), indexable beyond frame
    rect_w: int,  # visible tile width in this plane (clipped to frame)
    rect_h: int,
    x: int,  # tx block position within the tile (plane units)
    y: int,
    tx_size: TxSize,
    mi_x: int,  # partition position in *tile* mi units (luma)
    mi_y: int,
    bx: int,  # tx block index within partition
    by: int,
    partition_size: BlockSize,
    xdec: int,
    ydec: int,
    bit_depth: int,
    mode: Optional[PredictionMode],
    angle_delta: int = 0,
) -> IntraEdge:
    w, h = tx_size.width, tx_size.height
    base = 128 << (bit_depth - 8)

    needs_left = needs_topleft = needs_top = needs_topright = needs_bottomleft = True
    if mode is not None:
        m = mode
        if m == PredictionMode.PAETH_PRED:
            if x == 0 and y == 0:
                m = PredictionMode.DC_PRED
            elif x == 0:
                m = PredictionMode.V_PRED
            elif y == 0:
                m = PredictionMode.H_PRED
        p_angle = intra_mode_to_angle(m) + angle_delta * ANGLE_STEP
        dc_or_cfl = m in (PredictionMode.DC_PRED, PredictionMode.UV_CFL_PRED)
        needs_left = (not dc_or_cfl or x != 0) or (p_angle > 90 and p_angle != 180)
        needs_topleft = m == PredictionMode.PAETH_PRED or (
            m.is_directional() and p_angle != 90 and p_angle != 180
        )
        needs_top = (not dc_or_cfl or y != 0) or (p_angle != 90 and p_angle < 180)
        needs_topright = m.is_directional() and p_angle < 90
        needs_bottomleft = m.is_directional() and p_angle > 180

    above = np.zeros(w + h, dtype=np.int32)
    left = np.zeros(h + w, dtype=np.int32)

    # left column (top-to-bottom)
    if needs_left:
        txh = rect_h - y if y + h > rect_h else h
        if x != 0:
            col = rec[y : y + txh, x - 1]
            left[:txh] = col
            if txh < h:
                left[txh:h] = rec[y + txh - 1, x - 1]
        else:
            val = rec[y - 1, 0] if y != 0 else base + 1
            left[:h] = val

    # above row
    if needs_top:
        txw = rect_w - x if x + w > rect_w else w
        if y != 0:
            above[:txw] = rec[y - 1, x : x + txw]
            if txw < w:
                above[txw:w] = rec[y - 1, x + txw - 1]
        else:
            val = rec[0, x - 1] if x != 0 else base - 1
            above[:w] = val

    bx4 = bx * (w >> 2)
    by4 = by * (h >> 2)
    have_top = by4 != 0 or (mi_y > 1 if ydec else mi_y > 0)
    have_left = bx4 != 0 or (mi_x > 1 if xdec else mi_x > 0)
    right_available = x + w < rect_w
    bottom_available = y + h < rect_h
    scaled_size = supersample_chroma_bsize(partition_size, xdec, ydec)

    if needs_topright:
        # the extension fills above[w : w+h] (directional <90 reads up to
        # index w+h-1), so the cap is h — not w (wide tx sizes like 64x16
        # would otherwise overflow the buffer)
        num_avail = 0
        if y != 0 and has_top_right(
            scaled_size, mi_y, mi_x, have_top, right_available,
            tx_size, by4, bx4, xdec, ydec,
        ):
            num_avail = min(h, rect_w - x - w)
        if num_avail > 0:
            above[w : w + num_avail] = rec[y - 1, x + w : x + w + num_avail]
        if num_avail < h:
            above[w + num_avail : w + h] = above[w + num_avail - 1]

    if needs_bottomleft:
        num_avail = 0
        if x != 0 and has_bottom_left(
            scaled_size, mi_y, mi_x, bottom_available, have_left,
            tx_size, by4, bx4, xdec, ydec,
        ):
            num_avail = min(w, rect_h - y - h)  # fills left[h : h+w]
        if num_avail > 0:
            left[h : h + num_avail] = rec[y + h : y + h + num_avail, x - 1]
        if num_avail < w:
            left[h + num_avail : h + w] = left[h + num_avail - 1]

    # top-left
    if needs_topleft:
        if x == 0 and y == 0:
            tl = base
        elif y == 0:
            tl = int(rec[0, x - 1])
        elif x == 0:
            tl = int(rec[y - 1, 0])
        else:
            tl = int(rec[y - 1, x - 1])
        # filter corner for diagonal-ish modes on big blocks
        if (
            mode is not None
            and mode.is_directional()
            and _needs_topleft_filter(mode, angle_delta)
            and w + h >= 24
        ):
            l0 = int(left[h - 1]) if needs_left else tl
            a0 = int(above[0]) if needs_top else tl
            tl = (l0 * 5 + tl * 6 + a0 * 5 + 8) >> 4
    else:
        tl = base

    return IntraEdge(
        above=above,
        left=left,
        top_left=tl,
        have_above=(y != 0),
        have_left=(x != 0),
    )


def _needs_topleft_filter(mode: PredictionMode, angle_delta: int) -> bool:
    """Reference partition.rs:724: enable_intra_edge_filter && 90<angle<180."""
    p_angle = intra_mode_to_angle(mode) + angle_delta * ANGLE_STEP
    return 90 < p_angle < 180
