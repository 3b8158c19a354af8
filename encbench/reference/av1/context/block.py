"""Per-block mode-info grids and above/left context state.

Counterpart of the reference's ``FrameBlocks``/``BlockContext``
(``src/context/block_unit.rs``, ``src/context/partition_unit.rs``): a 4x4-mi
grid of coded block attributes plus the running above-row / left-column
context arrays that drive symbol context derivation.

Storage is struct-of-arrays (numpy) rather than array-of-structs — cheap to
checkpoint/rollback and batch-queryable from device code.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from encbench.reference.av1.partition import MI_SIZE_LOG2, BlockSize, PredictionMode
from encbench.reference.av1.tx import TxSize

COEFF_CONTEXT_BITS = 6
COEFF_CONTEXT_MASK = (1 << COEFF_CONTEXT_BITS) - 1
MIB_SIZE_LOG2 = 4  # 64x64 superblock = 16 mi
MIB_SIZE = 1 << MIB_SIZE_LOG2

# partition context codes per block size (normative derivation:
# bit b set => blocks of size (128 >> b) were split; spec Partition contexts)
def _partition_context_code(n_log2: int) -> int:
    """5-bit code with the top (5 - (n_log2-2)) bits set... derived so that
    size 4 -> 31, 8 -> 30, 16 -> 28, 32 -> 24, 64 -> 16, 128 -> 0."""
    return (0b11111 << (n_log2 - 2)) & 0b11111


class FrameBlocks:
    """Attributes of every coded 4x4 mi unit in a tile."""

    def __init__(self, cols: int, rows: int):
        self.cols = cols
        self.rows = rows
        self.mode = np.full((rows, cols), int(PredictionMode.DC_PRED), dtype=np.uint8)
        self.uv_mode = np.full((rows, cols), int(PredictionMode.DC_PRED), dtype=np.uint8)
        self.bsize = np.full((rows, cols), int(BlockSize.BLOCK_64X64), dtype=np.uint8)
        self.skip = np.zeros((rows, cols), dtype=bool)
        self.tx_size = np.full((rows, cols), int(TxSize.TX_64X64), dtype=np.uint8)
        self.segmentation_idx = np.zeros((rows, cols), dtype=np.uint8)
        self.is_inter_flag = np.zeros((rows, cols), dtype=bool)
        self.ref_frames = np.zeros((rows, cols, 2), dtype=np.int8)
        self.mv = np.zeros((rows, cols, 2, 2), dtype=np.int16)  # [..][ref][row,col]
        self.deblock_deltas = np.zeros((rows, cols, 4), dtype=np.int8)

    def set_rect(self, field: str, x: int, y: int, bsize: BlockSize, value) -> None:
        arr = getattr(self, field)
        w = min(bsize.width_mi, self.cols - x)
        h = min(bsize.height_mi, self.rows - y)
        arr[y : y + h, x : x + w] = value

    def subgrid(self, x: int, y: int, w: int, h: int) -> "FrameBlocks":
        """Tile view sharing storage (numpy slices) — the counterpart of the
        reference's disjoint ``TileBlocksMut`` views (tiling/tile_blocks.rs)."""
        sub = FrameBlocks.__new__(FrameBlocks)
        sub.cols = w
        sub.rows = h
        for f in (
            "mode", "uv_mode", "bsize", "skip", "tx_size", "segmentation_idx",
            "is_inter_flag", "deblock_deltas",
        ):
            setattr(sub, f, getattr(self, f)[y : y + h, x : x + w])
        sub.ref_frames = self.ref_frames[y : y + h, x : x + w]
        sub.mv = self.mv[y : y + h, x : x + w]
        return sub

    # neighbor queries --------------------------------------------------

    def above_of(self, x: int, y: int, field: str):
        return getattr(self, field)[y - 1, x]

    def left_of(self, x: int, y: int, field: str):
        return getattr(self, field)[y, x - 1]

    def above_left_of(self, x: int, y: int, field: str):
        return getattr(self, field)[y - 1, x - 1]


@dataclass
class BlockContextCheckpoint:
    sb_x: int
    above_partition: np.ndarray
    left_partition: np.ndarray
    above_tx: np.ndarray
    left_tx: np.ndarray
    above_coeff: list
    left_coeff: list
    cdef_coded: bool


class BlockContext:
    """Above-row / left-column running contexts for one tile."""

    def __init__(self, blocks: FrameBlocks, planes: int = 3):
        cols, rows = blocks.cols, blocks.rows
        self.blocks = blocks
        self.planes = planes
        self.cdef_coded = False
        self.code_deltas = False
        # partition contexts at 8x8 granularity
        self.above_partition_context = np.zeros((cols + 1) // 2 + 8, dtype=np.uint8)
        self.left_partition_context = np.zeros(MIB_SIZE >> 1, dtype=np.uint8)
        # tx size contexts (pixels)
        self.above_tx_context = np.zeros(cols + 16, dtype=np.uint8)
        self.left_tx_context = np.zeros(MIB_SIZE, dtype=np.uint8)
        # coefficient contexts per plane, per (subsampled) mi unit
        self.above_coeff_context = [np.zeros(cols + 16, dtype=np.uint8) for _ in range(3)]
        self.left_coeff_context = [np.zeros(MIB_SIZE, dtype=np.uint8) for _ in range(3)]

    # --- superblock-row / column resets -------------------------------

    def reset_left_contexts(self) -> None:
        self.left_partition_context[:] = 0
        self.left_tx_context[:] = 0
        for p in range(3):
            self.left_coeff_context[p][:] = 0

    # --- checkpoint/rollback (for RDO over one SB) ---------------------

    def checkpoint(self, sb_x_mi: int) -> BlockContextCheckpoint:
        x = sb_x_mi
        return BlockContextCheckpoint(
            sb_x=x,
            above_partition=self.above_partition_context[(x >> 1) : (x >> 1) + (MIB_SIZE >> 1)].copy(),
            left_partition=self.left_partition_context.copy(),
            above_tx=self.above_tx_context[x : x + MIB_SIZE].copy(),
            left_tx=self.left_tx_context.copy(),
            above_coeff=[
                self.above_coeff_context[p][(x >> (1 if p else 0)) : (x >> (1 if p else 0)) + MIB_SIZE].copy()
                for p in range(3)
            ],
            left_coeff=[self.left_coeff_context[p].copy() for p in range(3)],
            cdef_coded=self.cdef_coded,
        )

    def rollback(self, ck: BlockContextCheckpoint, xdec: int = 1) -> None:
        x = ck.sb_x
        self.cdef_coded = ck.cdef_coded
        self.above_partition_context[(x >> 1) : (x >> 1) + (MIB_SIZE >> 1)] = ck.above_partition
        self.left_partition_context[:] = ck.left_partition
        self.above_tx_context[x : x + MIB_SIZE] = ck.above_tx
        self.left_tx_context[:] = ck.left_tx
        for p in range(3):
            off = x >> ((1 if p else 0) if xdec else 0)
            self.above_coeff_context[p][off : off + MIB_SIZE] = ck.above_coeff[p]
            self.left_coeff_context[p][:] = ck.left_coeff[p]

    # --- partition contexts (partition_unit.rs:416-503) ----------------

    def partition_plane_context(self, x: int, y: int, bsize: BlockSize) -> int:
        above_ctx = int(self.above_partition_context[x >> 1])
        left_ctx = int(self.left_partition_context[(y & (MIB_SIZE - 1)) >> 1])
        bsl = bsize.width_log2 - 3  # log2 size relative to 8x8
        above = (above_ctx >> bsl) & 1
        left = (left_ctx >> bsl) & 1
        return (left * 2 + above) + bsl * 4

    def update_partition_context(self, x: int, y: int, subsize: BlockSize, bsize: BlockSize) -> None:
        bw = bsize.width_mi
        bh = bsize.height_mi
        code_w = _partition_context_code(subsize.width_log2)
        code_h = _partition_context_code(subsize.height_log2)
        self.above_partition_context[x >> 1 : (x + bw) >> 1] = code_w
        y_sb = y & (MIB_SIZE - 1)
        self.left_partition_context[y_sb >> 1 : (y_sb + bh) >> 1] = code_h

    # --- skip context ---------------------------------------------------

    def skip_context(self, x: int, y: int) -> int:
        above_skip = y > 0 and bool(self.blocks.skip[y - 1, x])
        left_skip = x > 0 and bool(self.blocks.skip[y, x - 1])
        return int(above_skip) + int(left_skip)

    # --- tx size context -------------------------------------------------

    def update_tx_size_context(self, x: int, y: int, bsize: BlockSize, tx_size: TxSize, skip: bool) -> None:
        n4_w, n4_h = bsize.width_mi, bsize.height_mi
        if skip:
            tx_w, tx_h = n4_w << MI_SIZE_LOG2, n4_h << MI_SIZE_LOG2
        else:
            tx_w, tx_h = tx_size.width, tx_size.height
        self.above_tx_context[x : x + n4_w] = tx_w
        y_sb = y & (MIB_SIZE - 1)
        self.left_tx_context[y_sb : y_sb + n4_h] = tx_h

    # --- coefficient contexts (block_unit.rs:333-525) --------------------

    def reset_skip_context(self, x: int, y: int, bsize: BlockSize, xdec: int, ydec: int, monochrome: bool, has_chroma_flag: bool) -> None:
        nplanes = 1 if monochrome else (3 if bsize >= BlockSize.BLOCK_8X8 else 1 + 2 * int(has_chroma_flag))
        for plane in range(nplanes):
            xd = 0 if plane == 0 else xdec
            yd = 0 if plane == 0 else ydec
            bw = max(bsize.width_mi >> xd, 1)
            bh = max(bsize.height_mi >> yd, 1)
            self.above_coeff_context[plane][(x >> xd) : (x >> xd) + bw] = 0
            y_sb = y & (MIB_SIZE - 1)
            self.left_coeff_context[plane][(y_sb >> yd) : (y_sb >> yd) + bh] = 0

    def get_txb_ctx(
        self,
        plane_bsize: BlockSize,
        tx_size: TxSize,
        plane: int,
        x: int,
        y: int,
        xdec: int,
        ydec: int,
        frame_clipped_txw: int,
        frame_clipped_txh: int,
    ):
        """(txb_skip_ctx, dc_sign_ctx) — reference block_unit.rs:441-527."""
        y_sb = y & (MIB_SIZE - 1)
        # tiny slices (<=16 elements): plain-python loops beat numpy overhead
        above = self.above_coeff_context[plane][(x >> xdec) : (x >> xdec) + (frame_clipped_txw >> 2)].tolist()
        left = self.left_coeff_context[plane][(y_sb >> ydec) : (y_sb >> ydec) + (frame_clipped_txh >> 2)].tolist()

        _SIGNS = (0, -1, 1)
        dc_sign = 0
        for v in above:
            dc_sign += _SIGNS[v >> COEFF_CONTEXT_BITS]
        for v in left:
            dc_sign += _SIGNS[v >> COEFF_CONTEXT_BITS]
        if dc_sign < 0:
            dc_sign_ctx = 1
        elif dc_sign > 0:
            dc_sign_ctx = 2
        else:
            dc_sign_ctx = 0

        if plane == 0:
            if plane_bsize.width == tx_size.width and plane_bsize.height == tx_size.height:
                txb_skip_ctx = 0
            else:
                top = 0
                for v in above:
                    top |= v
                top &= COEFF_CONTEXT_MASK
                lft = 0
                for v in left:
                    lft |= v
                lft &= COEFF_CONTEXT_MASK
                mx = min(top | lft, 4)
                mn = min(min(top, lft), 4)
                if mx == 0:
                    txb_skip_ctx = 1
                elif mn == 0:
                    txb_skip_ctx = 2 + (mx > 3)
                elif mx <= 3:
                    txb_skip_ctx = 4
                elif mn <= 3:
                    txb_skip_ctx = 5
                else:
                    txb_skip_ctx = 6
        else:
            top = 0
            for v in above:
                top |= v
            lft = 0
            for v in left:
                lft |= v
            ctx_base = int(top != 0) + int(lft != 0)
            ctx_offset = 10 if plane_bsize.width * plane_bsize.height > tx_size.area else 7
            txb_skip_ctx = ctx_base + ctx_offset
        return txb_skip_ctx, dc_sign_ctx

    def store_coeff_context(self, plane: int, x: int, y: int, tx_size: TxSize, xdec: int, ydec: int, value: int) -> None:
        w_mi = tx_size.width >> MI_SIZE_LOG2
        h_mi = tx_size.height >> MI_SIZE_LOG2
        xo = x >> xdec
        self.above_coeff_context[plane][xo : xo + w_mi] = value
        y_sb = (y & (MIB_SIZE - 1)) >> ydec
        self.left_coeff_context[plane][y_sb : y_sb + h_mi] = value
