"""Top-right / bottom-left reference pixel availability.

Counterpart of the reference's ``src/recon_intra.rs`` (has_top_right /
has_bottom_left).  Where the reference carries precomputed bit tables, we
*derive* availability by simulating the recursive z-order coding of a
superblock once per block size (cached) — the tables are a pure function of
the partition traversal order, and computing them keeps this module
table-free and exact (validated bit-for-bit against the reference tables in
tests/test_availability.py).
"""

from __future__ import annotations

import functools

import numpy as np

from encbench.reference.av1.partition import MI_SIZE_LOG2, BlockSize

SB128_MI = 32  # 128x128 superblock in 4x4 (mi) units
MAX_MIB_SIZE_LOG2 = 5


@functools.lru_cache(None)
def _coding_order(bw_mi: int, bh_mi: int) -> np.ndarray:
    """Visit order index for each (bw_mi x bh_mi) block in a 128x128 SB.

    Recursive z-order: square parents in Morton order; rectangular blocks
    ordered within their square parent (top-to-bottom for wide, left-to-right
    for tall).  Returns array[rows, cols] of order indices.
    """
    rows = SB128_MI // bh_mi
    cols = SB128_MI // bw_mi
    parent = max(bw_mi, bh_mi)

    def morton(r: int, c: int) -> int:
        m = 0
        for b in range(8):
            m |= ((r >> b) & 1) << (2 * b + 1)
            m |= ((c >> b) & 1) << (2 * b)
        return m

    order = np.zeros((rows, cols), dtype=np.int64)
    keys = []
    for r in range(rows):
        for c in range(cols):
            mi_r, mi_c = r * bh_mi, c * bw_mi
            pr, pc = mi_r // parent, mi_c // parent
            if bw_mi >= bh_mi:
                sub = (mi_r % parent) // bh_mi  # wide: top-to-bottom
            else:
                sub = (mi_c % parent) // bw_mi  # tall: left-to-right
            keys.append((morton(pr, pc), sub, r, c))
    for idx, (_, _, r, c) in enumerate(sorted(keys)):
        order[r, c] = idx
    return order


@functools.lru_cache(None)
def _unit_order(bw_mi: int, bh_mi: int) -> np.ndarray:
    """Coding order of each 4x4 unit (inherits its owner block's order)."""
    blocks = _coding_order(bw_mi, bh_mi)
    return np.repeat(np.repeat(blocks, bh_mi, axis=0), bw_mi, axis=1)


@functools.lru_cache(None)
def _has_tr_bit(bw_mi: int, bh_mi: int, blk_row: int, blk_col: int) -> bool:
    """Is the 4x4 unit above-right of this block coded before it?"""
    blocks = _coding_order(bw_mi, bh_mi)
    units = _unit_order(bw_mi, bh_mi)
    my_order = blocks[blk_row, blk_col]
    ur_r = blk_row * bh_mi - 1
    ur_c = (blk_col + 1) * bw_mi
    if ur_r < 0:
        return True  # in the superblock row above (always coded)
    if ur_c >= SB128_MI:
        return False  # in the next superblock to the right
    return bool(units[ur_r, ur_c] < my_order)


@functools.lru_cache(None)
def _has_bl_bit(bw_mi: int, bh_mi: int, blk_row: int, blk_col: int) -> bool:
    blocks = _coding_order(bw_mi, bh_mi)
    units = _unit_order(bw_mi, bh_mi)
    my_order = blocks[blk_row, blk_col]
    bl_r = (blk_row + 1) * bh_mi
    bl_c = blk_col * bw_mi - 1
    if bl_c < 0:
        return False  # left SB column, but below current row: not coded yet
    if bl_r >= SB128_MI:
        return False  # superblock row below
    return bool(units[bl_r, bl_c] < my_order)


def has_top_right(
    bsize: BlockSize,
    mi_row: int,
    mi_col: int,
    top_available: bool,
    right_available: bool,
    tx_size,
    row_off: int,
    col_off: int,
    ss_x: int,
    ss_y: int,
) -> bool:
    """Reference recon_intra.rs:174-241 semantics.

    ``row_off``/``col_off`` are the tx block offsets within the partition in
    (subsampled) mi units; ``mi_row``/``mi_col`` the partition position.
    """
    if not top_available or not right_available:
        return False

    bw_unit = bsize.width_mi
    plane_bw_unit = max(bw_unit >> ss_x, 1)
    top_right_count_unit = tx_size.width >> MI_SIZE_LOG2

    if row_off > 0:
        # inner tx rows: need enough pixels to the right inside the partition
        return col_off + top_right_count_unit < plane_bw_unit
    # top row of the partition
    if col_off + top_right_count_unit < plane_bw_unit:
        return True
    bw_in_mi_log2 = bsize.width_log2 - MI_SIZE_LOG2
    bh_in_mi_log2 = bsize.height_log2 - MI_SIZE_LOG2
    sb_mi_size = 16  # 64x64 superblocks
    blk_row_in_sb = (mi_row & (sb_mi_size - 1)) >> bh_in_mi_log2
    blk_col_in_sb = (mi_col & (sb_mi_size - 1)) >> bw_in_mi_log2
    if blk_row_in_sb == 0:
        return True
    if ((blk_col_in_sb + 1) << bw_in_mi_log2) >= sb_mi_size:
        return False
    return _has_tr_bit(bsize.width_mi, bsize.height_mi, blk_row_in_sb, blk_col_in_sb)


def has_bottom_left(
    bsize: BlockSize,
    mi_row: int,
    mi_col: int,
    bottom_available: bool,
    left_available: bool,
    tx_size,
    row_off: int,
    col_off: int,
    ss_x: int,
    ss_y: int,
) -> bool:
    """Reference recon_intra.rs:374-450 semantics."""
    if not bottom_available or not left_available:
        return False
    if col_off > 0:
        return False
    bh_unit = bsize.height_mi
    plane_bh_unit = max(bh_unit >> ss_y, 1)
    bottom_left_count_unit = tx_size.height >> MI_SIZE_LOG2
    if row_off + bottom_left_count_unit < plane_bh_unit:
        return True
    bw_in_mi_log2 = bsize.width_log2 - MI_SIZE_LOG2
    bh_in_mi_log2 = bsize.height_log2 - MI_SIZE_LOG2
    sb_mi_size = 16
    blk_row_in_sb = (mi_row & (sb_mi_size - 1)) >> bh_in_mi_log2
    blk_col_in_sb = (mi_col & (sb_mi_size - 1)) >> bw_in_mi_log2
    if blk_col_in_sb == 0:
        blk_start_row_off = (blk_row_in_sb << bh_in_mi_log2) >> ss_y
        row_off_in_sb = blk_start_row_off + row_off
        sb_height_unit = sb_mi_size >> ss_y
        return row_off_in_sb + bottom_left_count_unit < sb_height_unit
    if ((blk_row_in_sb + 1) << bh_in_mi_log2) >= sb_mi_size:
        return False
    return _has_bl_bit(bsize.width_mi, bsize.height_mi, blk_row_in_sb, blk_col_in_sb)
