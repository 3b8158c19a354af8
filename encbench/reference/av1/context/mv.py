"""Motion vector prediction: the ref-MV candidate stack.

Counterpart of the reference's ``setup_mvref_list`` / ``find_mvrefs``
(context/block_unit.rs:853-1441; AV1 spec 7.10.2 Find MV stack process).
Shared by encoder and decoder — it reads only the coded-blocks grid.

Round-1 scope: single-reference stacks (compound extension lands with
bidirectional prediction).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

from encbench.reference.av1.partition import BlockSize, PredictionMode

# RefType values (spec frame reference numbering)
NONE_FRAME = -1
INTRA_FRAME = 0
LAST_FRAME = 1
LAST2_FRAME = 2
LAST3_FRAME = 3
GOLDEN_FRAME = 4
BWDREF_FRAME = 5
ALTREF2_FRAME = 6
ALTREF_FRAME = 7

MVREF_ROW_COLS = 3
REF_CAT_LEVEL = 640
REFMV_OFFSET = 4
GLOBALMV_OFFSET = 3
NEWMV_CTX_MASK = (1 << GLOBALMV_OFFSET) - 1
GLOBALMV_CTX_MASK = (1 << (REFMV_OFFSET - GLOBALMV_OFFSET)) - 1
REFMV_CTX_MASK = (1 << (8 - REFMV_OFFSET)) - 1
MAX_REF_MV_STACK_SIZE = 8


def is_bwd_ref(rf: int) -> bool:
    return rf >= BWDREF_FRAME


def has_newmv(mode: int) -> bool:
    m = PredictionMode(mode)
    return m in (
        PredictionMode.NEWMV,
        PredictionMode.NEW_NEWMV,
        PredictionMode.NEAREST_NEWMV,
        PredictionMode.NEW_NEARESTMV,
        PredictionMode.NEAR_NEW0MV,
        PredictionMode.NEAR_NEW1MV,
        PredictionMode.NEAR_NEW2MV,
        PredictionMode.NEW_NEAR0MV,
        PredictionMode.NEW_NEAR1MV,
        PredictionMode.NEW_NEAR2MV,
    )


@dataclass
class CandidateMV:
    this_mv: Tuple[int, int]  # (row, col), 1/8-pel
    comp_mv: Tuple[int, int] = (0, 0)
    weight: int = 0


def has_tr_simple(x: int, y: int, bsize: BlockSize) -> bool:
    """Top-right availability for the MV scan (reference partition.rs:897)."""
    sb_mi = 16
    mask_row = y & (sb_mi - 1)
    mask_col = x & (sb_mi - 1)
    n4_w, n4_h = bsize.width_mi, bsize.height_mi
    bs = max(n4_w, n4_h)
    if bs > 16:
        return False
    has_tr = not ((mask_row & bs) and (mask_col & bs))
    while bs < sb_mi:
        if mask_col & bs:
            if (mask_col & (2 * bs)) and (mask_row & (2 * bs)):
                has_tr = False
                break
        else:
            break
        bs <<= 1
    if n4_w < n4_h and (x & n4_w) == 0:
        has_tr = True
    if n4_w > n4_h and (y & n4_h) != 0:
        has_tr = False
    return has_tr


class MvFinder:
    """Builds the candidate stack from the coded-blocks grid."""

    def __init__(self, blocks, frame_mi_cols: int, frame_mi_rows: int, tile_mi_x: int, tile_mi_y: int):
        self.blocks = blocks
        self.frame_cols = frame_mi_cols
        self.frame_rows = frame_mi_rows
        self.tile_x = tile_mi_x
        self.tile_y = tile_mi_y

    # -- block record helpers -------------------------------------------

    def _blk(self, x: int, y: int):
        b = self.blocks
        return (
            int(b.mode[y, x]),
            BlockSize(int(b.bsize[y, x])),
            (int(b.ref_frames[y, x, 0]), int(b.ref_frames[y, x, 1])),
            ((int(b.mv[y, x, 0, 0]), int(b.mv[y, x, 0, 1])),
             (int(b.mv[y, x, 1, 0]), int(b.mv[y, x, 1, 1]))),
        )

    @staticmethod
    def _is_inter_blk(mode, refs) -> bool:
        return refs[0] > INTRA_FRAME

    # -- candidate addition (block_unit.rs:853-910) ----------------------

    def _add_ref_mv_candidate(self, ref_frame, blk, stack, weight, newmv_count) -> Tuple[bool, int]:
        mode, _bs, refs, mvs = blk
        if not self._is_inter_blk(mode, refs):
            return False, newmv_count
        found = False
        if isinstance(ref_frame, tuple):
            # compound pair match (block_unit.rs add_ref_mv_candidate, compound arm)
            if refs[0] == ref_frame[0] and refs[1] == ref_frame[1]:
                key = (mvs[0], mvs[1])
                matched = False
                for cand in stack:
                    if (cand.this_mv, cand.comp_mv) == key:
                        cand.weight += weight
                        matched = True
                        break
                if not matched and len(stack) < MAX_REF_MV_STACK_SIZE:
                    stack.append(
                        CandidateMV(this_mv=mvs[0], comp_mv=mvs[1], weight=weight)
                    )
                if has_newmv(mode):
                    newmv_count += 1
                found = True
            return found, newmv_count
        for i in range(2):
            if refs[i] == ref_frame:
                mv = mvs[i]
                matched = False
                for cand in stack:
                    if cand.this_mv == mv:
                        cand.weight += weight
                        matched = True
                        break
                if not matched and len(stack) < MAX_REF_MV_STACK_SIZE:
                    stack.append(CandidateMV(this_mv=mv, weight=weight))
                if has_newmv(mode):
                    newmv_count += 1
                found = True
        return found, newmv_count

    # -- row/col scans (block_unit.rs:967-1125) --------------------------

    def _scan_row(self, x, y, row_offset, max_row_offs, processed_rows, ref_frame, stack, newmv_count, bsize):
        b = self.blocks
        target_n4_w = bsize.width_mi
        end_mi = min(min(target_n4_w, b.cols - x), 16)
        col_offset = 0
        if abs(row_offset) > 1:
            col_offset = 1
            if (x & 1) and target_n4_w < 2:
                col_offset -= 1
        use_step_16 = target_n4_w >= 16
        found = False
        i = 0
        while i < end_mi:
            cx = x + col_offset + i
            cy = y + row_offset
            blk = self._blk(cx, cy)
            n4_w = blk[1].width_mi
            ln = min(target_n4_w, n4_w)
            if use_step_16:
                ln = max(4, ln)
            elif abs(row_offset) > 1:
                ln = max(ln, 2)
            weight = 2
            if target_n4_w >= 2 and target_n4_w <= n4_w:
                inc = min(-max_row_offs + row_offset + 1, blk[1].height_mi)
                weight = max(weight, inc)
                processed_rows[0] = inc - row_offset - 1
            f, newmv_count = self._add_ref_mv_candidate(ref_frame, blk, stack, ln * weight, newmv_count)
            found |= f
            i += ln
        return found, newmv_count

    def _scan_col(self, x, y, col_offset, max_col_offs, processed_cols, ref_frame, stack, newmv_count, bsize):
        b = self.blocks
        target_n4_h = bsize.height_mi
        end_mi = min(min(target_n4_h, b.rows - y), 16)
        row_offset = 0
        if abs(col_offset) > 1:
            row_offset = 1
            if (y & 1) and target_n4_h < 2:
                row_offset -= 1
        use_step_16 = target_n4_h >= 16
        found = False
        i = 0
        while i < end_mi:
            cx = x + col_offset
            cy = y + row_offset + i
            blk = self._blk(cx, cy)
            n4_h = blk[1].height_mi
            ln = min(target_n4_h, n4_h)
            if use_step_16:
                ln = max(4, ln)
            elif abs(col_offset) > 1:
                ln = max(ln, 2)
            weight = 2
            if target_n4_h >= 2 and target_n4_h <= n4_h:
                inc = min(-max_col_offs + col_offset + 1, blk[1].width_mi)
                weight = max(weight, inc)
                processed_cols[0] = inc - col_offset - 1
            f, newmv_count = self._add_ref_mv_candidate(ref_frame, blk, stack, ln * weight, newmv_count)
            found |= f
            i += ln
        return found, newmv_count

    def _scan_blk(self, x, y, ref_frame, stack, newmv_count):
        b = self.blocks
        if x >= b.cols or y >= b.rows:
            return False, newmv_count
        return self._add_ref_mv_candidate(ref_frame, self._blk(x, y), stack, 2 * 2, newmv_count)

    # -- main (block_unit.rs:1127-1421) ----------------------------------

    def find_mvrefs(self, x: int, y: int, ref_frame: int, bsize: BlockSize, sign_bias) -> Tuple[List[CandidateMV], int]:
        """Returns (mv_stack, mode_context)."""
        stack: List[CandidateMV] = []
        b = self.blocks
        target_n4_h = bsize.height_mi
        target_n4_w = bsize.width_mi
        row_adj = target_n4_h < 2 and (y & 1) != 0
        col_adj = target_n4_w < 2 and (x & 1) != 0
        processed_rows = [0]
        processed_cols = [0]
        up_avail = y > 0
        left_avail = x > 0
        max_row_offs = 0
        max_col_offs = 0
        if up_avail:
            max_row_offs = -2 * MVREF_ROW_COLS + int(row_adj)
            if target_n4_h < 2:
                max_row_offs = -2 * 2 + int(row_adj)
            max_row_offs = min(max(max_row_offs, -y), b.rows - y - 1)
        if left_avail:
            max_col_offs = -2 * MVREF_ROW_COLS + int(col_adj)
            if target_n4_w < 2:
                max_col_offs = -2 * 2 + int(col_adj)
            max_col_offs = min(max(max_col_offs, -x), b.cols - x - 1)

        row_match = col_match = False
        newmv_count = 0
        if abs(max_row_offs) >= 1:
            f, newmv_count = self._scan_row(
                x, y, -1, max_row_offs, processed_rows, ref_frame, stack, newmv_count, bsize
            )
            row_match |= f
        if abs(max_col_offs) >= 1:
            f, newmv_count = self._scan_col(
                x, y, -1, max_col_offs, processed_cols, ref_frame, stack, newmv_count, bsize
            )
            col_match |= f
        if has_tr_simple(x, y, bsize) and y > 0:
            f, newmv_count = self._scan_blk(x + target_n4_w, y - 1, ref_frame, stack, newmv_count)
            row_match |= f

        nearest_match = int(row_match) + int(col_match)
        for cand in stack:
            cand.weight += REF_CAT_LEVEL

        far_newmv = 0
        if x > 0 and y > 0:
            f, far_newmv = self._scan_blk(x - 1, y - 1, ref_frame, stack, far_newmv)
            row_match |= f
        for idx in range(2, MVREF_ROW_COLS + 1):
            row_offset = -2 * idx + 1 + int(row_adj)
            col_offset = -2 * idx + 1 + int(col_adj)
            if abs(row_offset) <= abs(max_row_offs) and abs(row_offset) > processed_rows[0]:
                f, far_newmv = self._scan_row(
                    x, y, row_offset, max_row_offs, processed_rows, ref_frame, stack, far_newmv, bsize
                )
                row_match |= f
            if abs(col_offset) <= abs(max_col_offs) and abs(col_offset) > processed_cols[0]:
                f, far_newmv = self._scan_col(
                    x, y, col_offset, max_col_offs, processed_cols, ref_frame, stack, far_newmv, bsize
                )
                col_match |= f

        total_match = int(row_match) + int(col_match)

        if nearest_match == 0:
            mode_context = min(total_match, 1) + (total_match << REFMV_OFFSET)
        elif nearest_match == 1:
            mode_context = 3 - min(newmv_count, 1) + ((2 + total_match) << REFMV_OFFSET)
        else:
            mode_context = 5 - min(newmv_count, 1) + (5 << REFMV_OFFSET)

        stack.sort(key=lambda c: -c.weight)

        # 7.10.2.12 extra search when fewer than 2 candidates
        if len(stack) < 2:
            w4 = min(min(target_n4_w, 16), b.cols - x)
            h4 = min(min(target_n4_h, 16), b.rows - y)
            num4x4 = min(w4, h4)
            passes = range(int(not up_avail), int(left_avail) + 1)
            for p in passes:
                idx = 0
                while idx < num4x4 and len(stack) < 2:
                    if p == 0:
                        blk = self._blk(x + idx, y - 1)
                    else:
                        blk = self._blk(x - 1, y + idx)
                    mode, bs, refs, mvs = blk
                    for cand_list in range(2):
                        cand_ref = refs[cand_list]
                        if cand_ref > INTRA_FRAME:
                            mv = mvs[cand_list]
                            if sign_bias(cand_ref) != sign_bias(ref_frame):
                                mv = (-mv[0], -mv[1])
                            if not any(c.this_mv == mv for c in stack):
                                stack.append(CandidateMV(this_mv=mv, weight=2))
                    idx += bs.width_mi if p == 0 else bs.height_mi

        # clamp mvs to the allowed motion range
        frame_x = self.tile_x + x
        frame_y = self.tile_y + y
        blk_w = bsize.width
        blk_h = bsize.height
        border_w = 128 + blk_w * 8
        border_h = 128 + blk_h * 8
        mvx_min = -frame_x * 32 - border_w
        mvx_max = (self.frame_cols - frame_x - blk_w // 4) * 32 + border_w
        mvy_min = -frame_y * 32 - border_h
        mvy_max = (self.frame_rows - frame_y - blk_h // 4) * 32 + border_h
        for c in stack:
            c.this_mv = (
                min(max(c.this_mv[0], mvy_min), mvy_max),
                min(max(c.this_mv[1], mvx_min), mvx_max),
            )
            c.comp_mv = (
                min(max(c.comp_mv[0], mvy_min), mvy_max),
                min(max(c.comp_mv[1], mvx_min), mvx_max),
            )
        return stack, mode_context


def fill_neighbours_ref_counts(blocks, x: int, y: int):
    """Reference block_unit.rs:1444-1467: counts of each inter ref among the
    above/left neighbors -> [7] array (indexed by ref-1)."""
    counts = [0] * 7
    if y > 0:
        r0 = int(blocks.ref_frames[y - 1, x, 0])
        r1 = int(blocks.ref_frames[y - 1, x, 1])
        if r0 > INTRA_FRAME:
            counts[r0 - 1] += 1
            if r1 > INTRA_FRAME:
                counts[r1 - 1] += 1
    if x > 0:
        r0 = int(blocks.ref_frames[y, x - 1, 0])
        r1 = int(blocks.ref_frames[y, x - 1, 1])
        if r0 > INTRA_FRAME:
            counts[r0 - 1] += 1
            if r1 > INTRA_FRAME:
                counts[r1 - 1] += 1
    return counts


def ref_count_ctx(c0: int, c1: int) -> int:
    if c0 < c1:
        return 0
    if c0 == c1:
        return 1
    return 2
