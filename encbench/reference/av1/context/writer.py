"""ContextWriter: the symbol layer binding CDFs + block context to a Writer.

Counterpart of the reference's ``ContextWriter`` (``src/context/*.rs``):
every ``write_*`` method codes one syntax element with its derived context
and adapts the CDF through the undo log so RDO can roll back.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from encbench.reference.av1.context import lvmap
from encbench.reference.av1.context.block import (
    COEFF_CONTEXT_BITS,
    COEFF_CONTEXT_MASK,
    BlockContext,
)
from encbench.reference.av1.context.cdf import CDFContext, CDFContextLog
from encbench.reference.av1.ec import WriterBase, update_cdf
from encbench.reference.av1.partition import BlockSize, PartitionType, PredictionMode
from encbench.reference.av1.quantize import _scan_u16
from encbench.reference.av1.tables import scan_order
from encbench.reference.av1.tx import TxSize, TxType
from encbench.reference.av1.quantize import _scan_kind

MAX_ANGLE_DELTA = 3

# block size groups for y_mode_cdf (spec Size_Group lookup)
SIZE_GROUP_LOOKUP = [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 1, 1, 2, 2, 3, 3]

# intra mode -> context bucket (block_unit.rs:683)
INTRA_MODE_CONTEXT = [0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0]

# max_txsize_rect_lookup / sub_tx_size_map (transform_unit.rs:60-105)
MAX_TXSIZE_RECT = [
    TxSize.TX_4X4, TxSize.TX_4X8, TxSize.TX_8X4, TxSize.TX_8X8, TxSize.TX_8X16,
    TxSize.TX_16X8, TxSize.TX_16X16, TxSize.TX_16X32, TxSize.TX_32X16,
    TxSize.TX_32X32, TxSize.TX_32X64, TxSize.TX_64X32, TxSize.TX_64X64,
    TxSize.TX_64X64, TxSize.TX_64X64, TxSize.TX_64X64, TxSize.TX_4X16,
    TxSize.TX_16X4, TxSize.TX_8X32, TxSize.TX_32X8, TxSize.TX_16X64,
    TxSize.TX_64X16,
]
SUB_TX_SIZE_MAP = [
    TxSize.TX_4X4, TxSize.TX_4X4, TxSize.TX_8X8, TxSize.TX_16X16,
    TxSize.TX_32X32, TxSize.TX_4X4, TxSize.TX_4X4, TxSize.TX_8X8,
    TxSize.TX_8X8, TxSize.TX_16X16, TxSize.TX_16X16, TxSize.TX_32X32,
    TxSize.TX_32X32, TxSize.TX_4X8, TxSize.TX_8X4, TxSize.TX_8X16,
    TxSize.TX_16X8, TxSize.TX_16X32, TxSize.TX_32X16,
]
MAX_TX_DEPTH = 2

# tx set signaling tables (transform_unit.rs:36-58)
NUM_TX_SET = [1, 2, 5, 7, 12, 16]
TX_SET_INDEX_INTRA = [0, -1, 2, 1, -1, -1]
TX_SET_INDEX_INTER = [0, 3, -1, -1, 2, 1]
AV1_TX_IND = [
    [0] * 16,
    [1] + [0] * 15,
    [1, 3, 4, 2] + [0] * 12,
    [1, 5, 6, 4, 0, 0, 0, 0, 0, 0, 2, 3, 0, 0, 0, 0],
    [3, 4, 5, 8, 6, 7, 9, 10, 11, 0, 1, 2, 0, 0, 0, 0],
    [7, 8, 9, 12, 10, 11, 13, 14, 15, 0, 1, 2, 3, 4, 5, 6],
]

# intra mode -> preferred uv tx type context (transform_unit.rs:162-197)
INTRA_MODE_TO_TX_TYPE = [
    TxType.DCT_DCT, TxType.ADST_DCT, TxType.DCT_ADST, TxType.DCT_DCT,
    TxType.ADST_ADST, TxType.ADST_DCT, TxType.DCT_ADST, TxType.DCT_ADST,
    TxType.ADST_DCT, TxType.ADST_ADST, TxType.ADST_DCT, TxType.DCT_ADST,
    TxType.ADST_ADST, TxType.DCT_DCT,  # CFL behaves as DC
]


def uv_intra_mode_to_tx_type_context(uv_mode: PredictionMode) -> TxType:
    return INTRA_MODE_TO_TX_TYPE[int(uv_mode)]


class ContextWriter:
    """fc = CDFContext, bc = BlockContext, log = CDF undo log."""

    def __init__(self, fc: CDFContext, bc: BlockContext):
        self.fc = fc
        self.bc = bc
        self.log = CDFContextLog()

    # --- checkpointing -------------------------------------------------

    def checkpoint(self, sb_x_mi: int = 0):
        return (self.log.checkpoint(), self.bc.checkpoint(sb_x_mi))

    def rollback(self, ckpt) -> None:
        self.log.rollback(ckpt[0])
        self.bc.rollback(ckpt[1])

    # --- core symbol op ------------------------------------------------

    def _sym(self, w, s: int, arr: np.ndarray, *idx) -> None:
        """Code s against arr[idx] with adaptation + undo logging.

        With a native encoder backend the CDF row adapts in place in C++
        (final-emission pass needs no rollback); the Python path logs for
        RDO rollback.
        """
        from encbench.reference.av1.utils import desync

        if desync.enabled():
            desync.log_symbol("enc", s)
        elif getattr(w, "symbol_update_row", None) is not None:
            w.symbol_update_row(s, arr, idx)
            return
        row = self.log.push(arr, idx)
        cdf = row.tolist()
        w.symbol(s, cdf)
        update_cdf(cdf, s)
        arr[idx] = cdf

    # --- partitions (partition_unit.rs:267-357) -------------------------

    def write_partition(
        self, w: WriterBase, x: int, y: int, p: PartitionType, bsize: BlockSize
    ) -> None:
        assert bsize.is_sqr() and bsize >= BlockSize.BLOCK_8X8
        hbs = bsize.width_mi // 2
        has_cols = (x + hbs) < self.bc.blocks.cols
        has_rows = (y + hbs) < self.bc.blocks.rows
        ctx = self.bc.partition_plane_context(x, y, bsize)
        if not has_rows and not has_cols:
            return
        if ctx < 4:
            arr, aidx = self.fc.partition_w8_cdf, ctx
        elif ctx < 16:
            arr, aidx = self.fc.partition_cdf, ctx - 4
        else:
            arr, aidx = self.fc.partition_w128_cdf, ctx - 16
        if has_rows and has_cols:
            self._sym(w, int(p), arr, aidx)
        else:
            # only the split-vs-forced direction bool is coded, from a CDF
            # gathered over the partition distribution (no adaptation)
            cdf_in = arr[aidx].tolist()
            split = p == PartitionType.PARTITION_SPLIT
            if not has_rows:
                if p not in (PartitionType.PARTITION_SPLIT, PartitionType.PARTITION_HORZ):
                    raise ValueError(f"illegal partition {p} without rows")
                gathered = self._gather_split_prob(cdf_in, vert_alike=True)
            else:
                if p not in (PartitionType.PARTITION_SPLIT, PartitionType.PARTITION_VERT):
                    raise ValueError(f"illegal partition {p} without cols")
                gathered = self._gather_split_prob(cdf_in, vert_alike=False)
            w.symbol(1 if split else 0, gathered)

    @staticmethod
    def _gather_split_prob(cdf_in, vert_alike: bool):
        """partition_gather_{vert,horz}_alike (partition_unit.rs:131-193)."""

        def elem_prob(s):
            prev = cdf_in[s - 1] if s > 0 else 32768
            cur = cdf_in[s] if s < len(cdf_in) - 1 else 0
            return prev - cur

        if vert_alike:
            members = [
                PartitionType.PARTITION_VERT,
                PartitionType.PARTITION_SPLIT,
                PartitionType.PARTITION_HORZ_A,
                PartitionType.PARTITION_VERT_A,
                PartitionType.PARTITION_VERT_B,
                PartitionType.PARTITION_VERT_4,
            ]
        else:
            members = [
                PartitionType.PARTITION_HORZ,
                PartitionType.PARTITION_SPLIT,
                PartitionType.PARTITION_HORZ_A,
                PartitionType.PARTITION_HORZ_B,
                PartitionType.PARTITION_VERT_A,
                PartitionType.PARTITION_HORZ_4,
            ]
        out0 = 32768
        for m in members:
            if int(m) < len(cdf_in):
                out0 -= elem_prob(int(m))
        out0 = 32768 - out0
        return (out0, 0)

    # --- modes ----------------------------------------------------------

    def write_skip(self, w: WriterBase, x: int, y: int, skip: bool) -> None:
        ctx = self.bc.skip_context(x, y)
        self._sym(w, int(skip), self.fc.skip_cdfs, ctx)

    def _skip_mode_at(self, x: int, y: int) -> bool:
        """Whether the mi cell was coded via skip mode.  The encoder forces
        every qualifying block (compound NEAREST_NEARESTMV + skip) through
        the skip-mode syntax, so the predicate equals the coded flag."""
        b = self.bc.blocks
        return (
            bool(b.is_inter_flag[y, x])
            and int(b.mode[y, x]) == int(PredictionMode.NEAREST_NEARESTMV)
            and bool(b.skip[y, x])
            and int(b.ref_frames[y, x, 1]) > 0
        )

    def write_skip_mode(self, w: WriterBase, x: int, y: int, sm: bool) -> None:
        ctx = int(y > 0 and self._skip_mode_at(x, y - 1)) + int(
            x > 0 and self._skip_mode_at(x - 1, y)
        )
        self._sym(w, int(sm), self.fc.skip_mode_cdfs, ctx)

    def write_intra_mode_kf(self, w: WriterBase, x: int, y: int, mode: PredictionMode) -> None:
        above = int(self.bc.blocks.mode[y - 1, x]) if y > 0 else int(PredictionMode.DC_PRED)
        left = int(self.bc.blocks.mode[y, x - 1]) if x > 0 else int(PredictionMode.DC_PRED)
        self._sym(w, int(mode), self.fc.kf_y_cdf, INTRA_MODE_CONTEXT[above], INTRA_MODE_CONTEXT[left])

    def write_intra_mode(self, w: WriterBase, bsize: BlockSize, mode: PredictionMode) -> None:
        self._sym(w, int(mode), self.fc.y_mode_cdf, SIZE_GROUP_LOOKUP[int(bsize)])

    def write_intra_uv_mode(
        self, w: WriterBase, uv_mode: PredictionMode, y_mode: PredictionMode, bsize: BlockSize
    ) -> None:
        if cfl_allowed(bsize):
            self._sym(w, int(uv_mode), self.fc.uv_mode_cfl_cdf, int(y_mode))
        else:
            self._sym(w, int(uv_mode), self.fc.uv_mode_cdf, int(y_mode))

    def write_angle_delta(self, w: WriterBase, angle: int, mode: PredictionMode) -> None:
        self._sym(
            w,
            angle + MAX_ANGLE_DELTA,
            self.fc.angle_delta_cdf,
            int(mode) - int(PredictionMode.V_PRED),
        )

    def write_cfl_alphas(self, w: WriterBase, joint_sign: int, u_idx: int, v_idx: int) -> None:
        """joint_sign in 0..7; u_idx/v_idx = scale-1 (ignored if sign zero)."""
        self._sym(w, joint_sign, self.fc.cfl_sign_cdf)
        sign_u = (joint_sign + 1) // 3
        sign_v = (joint_sign + 1) % 3
        if sign_u != 0:
            ctx_u = (sign_u - 1) * 3 + sign_v
            self._sym(w, u_idx, self.fc.cfl_alpha_cdf, ctx_u)
        if sign_v != 0:
            ctx_v = (sign_v - 1) * 3 + sign_u
            self._sym(w, v_idx, self.fc.cfl_alpha_cdf, ctx_v)

    def write_use_filter_intra(self, w: WriterBase, enable: bool, bsize: BlockSize) -> None:
        self._sym(w, int(enable), self.fc.filter_intra_cdfs, int(bsize))

    # --- tx size (transform_unit.rs:576-667) -----------------------------

    def _get_tx_size_context(self, x: int, y: int, bsize: BlockSize) -> int:
        max_tx = MAX_TXSIZE_RECT[int(bsize)]
        has_above, has_left = y > 0, x > 0
        above = int(self.bc.above_tx_context[x]) >= max_tx.width
        left = int(self.bc.left_tx_context[y & 15]) >= max_tx.height
        if has_above and self.bc.blocks.is_inter_flag[y - 1, x]:
            above_bs = BlockSize(int(self.bc.blocks.bsize[y - 1, x]))
            above = above_bs.width >= max_tx.width
        if has_left and self.bc.blocks.is_inter_flag[y, x - 1]:
            left_bs = BlockSize(int(self.bc.blocks.bsize[y, x - 1]))
            left = left_bs.height >= max_tx.height
        if has_above and has_left:
            return int(above) + int(left)
        if has_above:
            return int(above)
        if has_left:
            return int(left)
        return 0

    def write_tx_size_intra(self, w: WriterBase, x: int, y: int, bsize: BlockSize, tx_size: TxSize) -> None:
        def tx_size_to_depth(t, bs):
            ctx_size = MAX_TXSIZE_RECT[int(bs)]
            depth = 0
            while t != ctx_size:
                depth += 1
                ctx_size = SUB_TX_SIZE_MAP[int(ctx_size)]
            return depth

        def bsize_to_tx_size_cat(bs):
            t = MAX_TXSIZE_RECT[int(bs)]
            depth = 0
            while t != TxSize.TX_4X4:
                depth += 1
                t = SUB_TX_SIZE_MAP[int(t)]
            return depth - 1

        tx_size_ctx = self._get_tx_size_context(x, y, bsize)
        depth = tx_size_to_depth(tx_size, bsize)
        cat = bsize_to_tx_size_cat(bsize)
        if cat > 0:
            self._sym(w, depth, self.fc.tx_size_cdf, cat - 1, tx_size_ctx)
        else:
            self._sym(w, depth, self.fc.tx_size_8x8_cdf, tx_size_ctx)

    # --- tx type (transform_unit.rs:530-574) ------------------------------

    def write_tx_type(
        self,
        w: WriterBase,
        tx_size: TxSize,
        tx_type: TxType,
        y_mode: PredictionMode,
        is_inter: bool,
        use_reduced_tx_set: bool,
    ) -> None:
        from encbench.reference.av1.tx import get_tx_set

        tx_set = get_tx_set(tx_size, is_inter, use_reduced_tx_set)
        if NUM_TX_SET[int(tx_set)] <= 1:
            return
        square = int(tx_size.sqr())
        s = AV1_TX_IND[int(tx_set)][int(tx_type)]
        if is_inter:
            idx = TX_SET_INDEX_INTER[int(tx_set)]
            if idx == 1:
                self._sym(w, s, self.fc.inter_tx_1_cdf, square)
            elif idx == 2:
                self._sym(w, s, self.fc.inter_tx_2_cdf, square)
            else:
                self._sym(w, s, self.fc.inter_tx_3_cdf, square)
        else:
            idx = TX_SET_INDEX_INTRA[int(tx_set)]
            if idx == 1:
                self._sym(w, s, self.fc.intra_tx_1_cdf, square, int(y_mode))
            else:
                self._sym(w, s, self.fc.intra_tx_2_cdf, square, int(y_mode))

    # --- inter modes (frame_header.rs:67, block_unit.rs:1660-1782) --------

    def write_is_inter(self, w, x: int, y: int, is_inter: bool) -> None:
        ctx = self._intra_inter_context(x, y)
        self._sym(w, int(is_inter), self.fc.intra_inter_cdfs, ctx)

    def _intra_inter_context(self, x: int, y: int) -> int:
        b = self.bc.blocks
        has_above, has_left = y > 0, x > 0
        if has_above and has_left:
            above_intra = not bool(b.is_inter_flag[y - 1, x])
            left_intra = not bool(b.is_inter_flag[y, x - 1])
            return 3 if (above_intra and left_intra) else int(above_intra or left_intra)
        if has_above:
            return 2 if not bool(b.is_inter_flag[y - 1, x]) else 0
        if has_left:
            return 2 if not bool(b.is_inter_flag[y, x - 1]) else 0
        return 0

    def write_ref_frames_single(self, w, x: int, y: int, ref_frame: int, counts) -> None:
        """Single-reference coding path (frame_header.rs:121-160)."""
        from encbench.reference.av1.context import mv as MV

        def rctx(c0, c1):
            return MV.ref_count_ctx(c0, c1)

        fwd = counts[0] + counts[1] + counts[2] + counts[3]
        bwd = counts[4] + counts[5] + counts[6]
        b0 = MV.is_bwd_ref(ref_frame)
        self._sym(w, int(b0), self.fc.single_ref_cdfs, rctx(fwd, bwd), 0)
        if b0:
            b1 = ref_frame == MV.ALTREF_FRAME
            ctx = rctx(counts[4] + counts[5], counts[6])
            self._sym(w, int(b1), self.fc.single_ref_cdfs, ctx, 1)
            if not b1:
                b5 = ref_frame == MV.ALTREF2_FRAME
                self._sym(w, int(b5), self.fc.single_ref_cdfs, rctx(counts[4], counts[5]), 5)
        else:
            b2 = ref_frame in (MV.LAST3_FRAME, MV.GOLDEN_FRAME)
            ctx = rctx(counts[0] + counts[1], counts[2] + counts[3])
            self._sym(w, int(b2), self.fc.single_ref_cdfs, ctx, 2)
            if not b2:
                b3 = ref_frame != MV.LAST_FRAME
                self._sym(w, int(b3), self.fc.single_ref_cdfs, rctx(counts[0], counts[1]), 3)
            else:
                b4 = ref_frame != MV.LAST3_FRAME
                self._sym(w, int(b4), self.fc.single_ref_cdfs, rctx(counts[2], counts[3]), 4)

    def write_inter_mode(self, w, mode: PredictionMode, ctx: int) -> None:
        from encbench.reference.av1.context.mv import (
            GLOBALMV_CTX_MASK,
            GLOBALMV_OFFSET,
            NEWMV_CTX_MASK,
            REFMV_CTX_MASK,
            REFMV_OFFSET,
        )

        newmv_ctx = ctx & NEWMV_CTX_MASK
        self._sym(w, int(mode != PredictionMode.NEWMV), self.fc.newmv_cdf, newmv_ctx)
        if mode != PredictionMode.NEWMV:
            zeromv_ctx = (ctx >> GLOBALMV_OFFSET) & GLOBALMV_CTX_MASK
            self._sym(w, int(mode != PredictionMode.GLOBALMV), self.fc.zeromv_cdf, zeromv_ctx)
            if mode != PredictionMode.GLOBALMV:
                refmv_ctx = (ctx >> REFMV_OFFSET) & REFMV_CTX_MASK
                self._sym(w, int(mode != PredictionMode.NEARESTMV), self.fc.refmv_cdf, refmv_ctx)

    def write_drl_mode(self, w, drl: bool, ctx: int) -> None:
        self._sym(w, int(drl), self.fc.drl_cdfs, ctx)

    def write_mv(self, w, mv, ref_mv, precision: int) -> None:
        """precision: 0=int only, 1=low (no hp bit), 2=high (context/mod.rs
        encode_mv_component; spec assign_mv)."""
        diff = (mv[0] - ref_mv[0], mv[1] - ref_mv[1])
        j = (int(diff[1] != 0)) | (int(diff[0] != 0) << 1)
        # joint: 0=zero,1=hnzvz(col only),2=hzvnz(row only),3=both
        self._sym(w, j, self.fc.nmv_joints_cdf)
        if diff[0] != 0:
            self._encode_mv_component(w, diff[0], 0, precision)
        if diff[1] != 0:
            self._encode_mv_component(w, diff[1], 1, precision)

    def _encode_mv_component(self, w, comp: int, axis: int, precision: int) -> None:
        sign = int(comp < 0)
        mag = -comp if sign else comp
        z = mag - 1
        if z >= 2 * 4096:
            mv_class = 10
        else:
            mv_class = max((z >> 3).bit_length() - 1, 0)
        base = 0 if mv_class == 0 else (2 << (mv_class + 2))
        offset = z - base
        d = offset >> 3
        fr = (offset >> 1) & 3
        hp = offset & 1
        self._sym(w, sign, self.fc.nmv_sign_cdf, axis)
        self._sym(w, mv_class, self.fc.nmv_classes_cdf, axis)
        if mv_class == 0:
            self._sym(w, d, self.fc.nmv_class0_cdf, axis)
        else:
            for i in range(mv_class + 1 - 1):  # CLASS0_BITS=1
                self._sym(w, (d >> i) & 1, self.fc.nmv_bits_cdf, axis, i)
        if precision > 0:
            if mv_class == 0:
                self._sym(w, fr, self.fc.nmv_class0_fp_cdf, axis, d)
            else:
                self._sym(w, fr, self.fc.nmv_fp_cdf, axis)
        if precision > 1:
            if mv_class == 0:
                self._sym(w, hp, self.fc.nmv_class0_hp_cdf, axis)
            else:
                self._sym(w, hp, self.fc.nmv_hp_cdf, axis)

    def write_tx_size_inter(
        self, w, x: int, y: int, bsize: BlockSize, tx_size: TxSize,
        txfm_split: bool, tbx: int, tby: int, depth: int,
    ) -> None:
        """Var-tx signaling (transform_unit.rs:727-773); we always code
        txfm_split=False (whole-block tx) for now."""
        if x >= self.bc.blocks.cols or y >= self.bc.blocks.rows:
            return
        if tx_size != TxSize.TX_4X4 and depth < 2:
            ctx = self._txfm_partition_context(x, y, bsize, tx_size, tbx, tby)
            self._sym(w, int(txfm_split), self.fc.txfm_partition_cdf, ctx)
        if not txfm_split:
            self.bc.update_tx_size_context(
                x, y, BlockSize.from_wh(tx_size.width, tx_size.height), tx_size, False
            )
        else:
            sub = SUB_TX_SIZE_MAP[int(tx_size)]
            bw = bsize.width_mi // max(sub.width >> 2, 1)
            bh = bsize.height_mi // max(sub.height >> 2, 1)
            for by in range(bh):
                for bx in range(bw):
                    self.write_tx_size_inter(
                        w, x + bx * (sub.width >> 2), y + by * (sub.height >> 2),
                        bsize, sub, False, bx, by, depth + 1,
                    )

    def _txfm_partition_context(self, x, y, bsize: BlockSize, tx_size: TxSize, tbx: int, tby: int) -> int:
        b = self.bc.blocks
        # above tx width
        if tby == 0:
            if y == 0:
                above = 64
            else:
                ab_inter = bool(b.is_inter_flag[y - 1, x])
                ab_skip = bool(b.skip[y - 1, x])
                if ab_skip and ab_inter:
                    above = BlockSize(int(b.bsize[y - 1, x])).width
                else:
                    above = int(self.bc.above_tx_context[x])
        else:
            above = int(self.bc.above_tx_context[x])
        if tbx == 0:
            if x == 0:
                left = 64
            else:
                l_inter = bool(b.is_inter_flag[y, x - 1])
                l_skip = bool(b.skip[y, x - 1])
                if l_skip and l_inter:
                    left = BlockSize(int(b.bsize[y, x - 1])).height
                else:
                    left = int(self.bc.left_tx_context[y & 15])
        else:
            left = int(self.bc.left_tx_context[y & 15])
        above_f = int(above < tx_size.width)
        left_f = int(left < tx_size.height)
        max_tx = MAX_TXSIZE_RECT[int(bsize)].sqr_up()
        category = int(tx_size.sqr_up() != max_tx) + (5 - 1 - int(max_tx)) * 2
        return category * 3 + above_f + left_f

    # --- coefficients (block_unit.rs:1783-2016) ---------------------------

    def write_coeffs_lv_map(
        self,
        w: WriterBase,
        plane: int,
        x: int,
        y: int,
        qcoeffs: np.ndarray,
        eob: int,
        pred_mode: PredictionMode,
        tx_size: TxSize,
        tx_type: TxType,
        plane_bsize: BlockSize,
        xdec: int,
        ydec: int,
        use_reduced_tx_set: bool,
        frame_clipped_txw: int,
        frame_clipped_txh: int,
    ) -> bool:
        is_inter = not pred_mode.is_intra()
        cw, ch = lvmap.coded_dims(tx_size)
        txs_ctx = lvmap.txsize_entropy_ctx(tx_size)
        txb_skip_ctx, dc_sign_ctx = self.bc.get_txb_ctx(
            plane_bsize, tx_size, plane, x, y, xdec, ydec,
            frame_clipped_txw, frame_clipped_txh,
        )
        plane_type = int(plane != 0)

        self._sym(w, int(eob == 0), self.fc.txb_skip_cdf, txs_ctx, txb_skip_ctx)
        if eob == 0:
            self.bc.store_coeff_context(plane, x, y, tx_size, xdec, ydec, 0)
            return False

        cls = lvmap.tx_class(tx_type)

        if plane == 0:
            self.write_tx_type(w, tx_size, tx_type, pred_mode, is_inter, use_reduced_tx_set)

        from encbench.reference.av1.utils import desync as _desync

        if getattr(w, "lib", None) is not None and not _desync.enabled():
            # native fast path: whole coefficient block coded in C++
            eob_multi_size = tx_size.width_log2 + tx_size.height_log2 - 4
            eob_arrs = getattr(self.fc, "_eob_arrs", None)
            if eob_arrs is None:
                eob_arrs = (
                    self.fc.eob_flag_cdf16, self.fc.eob_flag_cdf32,
                    self.fc.eob_flag_cdf64, self.fc.eob_flag_cdf128,
                    self.fc.eob_flag_cdf256, self.fc.eob_flag_cdf512,
                    self.fc.eob_flag_cdf1024,
                )
                self.fc._eob_arrs = eob_arrs
            eob_cdf_arr = eob_arrs[min(eob_multi_size, 6)]
            eob_row = eob_cdf_arr[plane_type, int(cls != lvmap.TX_CLASS_2D)]
            q = np.ascontiguousarray(qcoeffs, dtype=np.int32)
            scan_arr = _scan_u16(cw, ch, _scan_kind(tx_type))
            cul = w.lib.ectx_write_coeffs(
                w.h,
                q.ctypes.data, tx_size.width, tx_size.height, cw, ch, eob,
                scan_arr.ctypes.data, cls, plane_type, dc_sign_ctx,
                eob_row.ctypes.data, eob_row.shape[-1],
                self.fc.eob_extra_cdf[txs_ctx, plane_type].ctypes.data,
                self.fc.coeff_base_eob_cdf[txs_ctx, plane_type].ctypes.data,
                self.fc.coeff_base_cdf[txs_ctx, plane_type].ctypes.data,
                self.fc.coeff_br_cdf[min(txs_ctx, int(TxSize.TX_32X32)), plane_type].ctypes.data,
                self.fc.dc_sign_cdf[plane_type, dc_sign_ctx].ctypes.data,
            )
            self.bc.store_coeff_context(plane, x, y, tx_size, xdec, ydec, cul)
            return True

        from encbench.reference.av1.ec import WriterCounter

        if type(w) is WriterCounter and not _desync.enabled():
            from encbench.reference.av1 import native as _native

            lib = _native.get_lib()
            if lib is not None:
                # native rate counting: identical symbol sequence + CDF
                # adaptation as the write path; whole-region undo snapshots
                # replace the per-symbol log entries
                eob_multi_size = tx_size.width_log2 + tx_size.height_log2 - 4
                eob_arrs = getattr(self.fc, "_eob_arrs", None)
                if eob_arrs is None:
                    eob_arrs = (
                        self.fc.eob_flag_cdf16, self.fc.eob_flag_cdf32,
                        self.fc.eob_flag_cdf64, self.fc.eob_flag_cdf128,
                        self.fc.eob_flag_cdf256, self.fc.eob_flag_cdf512,
                        self.fc.eob_flag_cdf1024,
                    )
                    self.fc._eob_arrs = eob_arrs
                eob_cdf_arr = eob_arrs[min(eob_multi_size, 6)]
                eob_multi_ctx = int(cls != lvmap.TX_CLASS_2D)
                br_txs = min(txs_ctx, int(TxSize.TX_32X32))
                L = self.log
                L.push(eob_cdf_arr, (plane_type, eob_multi_ctx))
                L.push(self.fc.eob_extra_cdf, (txs_ctx, plane_type))
                L.push(self.fc.coeff_base_eob_cdf, (txs_ctx, plane_type))
                L.push(self.fc.coeff_base_cdf, (txs_ctx, plane_type))
                L.push(self.fc.coeff_br_cdf, (br_txs, plane_type))
                L.push(self.fc.dc_sign_cdf, (plane_type, dc_sign_ctx))
                eob_row = eob_cdf_arr[plane_type, eob_multi_ctx]
                q = np.ascontiguousarray(qcoeffs, dtype=np.int32)
                scan_arr = _scan_u16(cw, ch, _scan_kind(tx_type))
                st = np.array([w.rng, 0], dtype=np.int64)
                cul = lib.ectx_count_coeffs(
                    st.ctypes.data,
                    q.ctypes.data, tx_size.width, tx_size.height, cw, ch, eob,
                    scan_arr.ctypes.data, cls, plane_type, dc_sign_ctx,
                    eob_row.ctypes.data, eob_row.shape[-1],
                    self.fc.eob_extra_cdf[txs_ctx, plane_type].ctypes.data,
                    self.fc.coeff_base_eob_cdf[txs_ctx, plane_type].ctypes.data,
                    self.fc.coeff_base_cdf[txs_ctx, plane_type].ctypes.data,
                    self.fc.coeff_br_cdf[br_txs, plane_type].ctypes.data,
                    self.fc.dc_sign_cdf[plane_type, dc_sign_ctx].ctypes.data,
                )
                w.rng = int(st[0])
                w.bits += int(st[1])
                self.bc.store_coeff_context(plane, x, y, tx_size, xdec, ydec, cul)
                return True

        scan = scan_order(cw, ch, _scan_kind(tx_type))[:eob]
        sub = qcoeffs[:ch, :cw].reshape(-1)
        coeffs = sub[scan].astype(np.int64)

        levels = lvmap.init_levels(qcoeffs, cw, ch)

        # EOB position
        eob_pt, eob_extra = lvmap.get_eob_pos_token(eob)
        eob_multi_size = tx_size.width_log2 + tx_size.height_log2 - 4
        eob_multi_ctx = int(cls != lvmap.TX_CLASS_2D)
        eob_cdf_arr = [
            self.fc.eob_flag_cdf16, self.fc.eob_flag_cdf32, self.fc.eob_flag_cdf64,
            self.fc.eob_flag_cdf128, self.fc.eob_flag_cdf256, self.fc.eob_flag_cdf512,
            self.fc.eob_flag_cdf1024,
        ][min(eob_multi_size, 6)]
        self._sym(w, eob_pt - 1, eob_cdf_arr, plane_type, eob_multi_ctx)

        offset_bits = lvmap.K_EOB_OFFSET_BITS[eob_pt]
        if offset_bits > 0:
            eob_shift = offset_bits - 1
            bit = int((eob_extra & (1 << eob_shift)) != 0)
            self._sym(w, bit, self.fc.eob_extra_cdf, txs_ctx, plane_type, eob_pt - 3)
            for i in range(1, offset_bits):
                eob_shift = offset_bits - 1 - i
                w.bit(int((eob_extra & (1 << eob_shift)) != 0))

        # base + br levels, reverse scan order
        area = cw * ch
        for c in range(eob - 1, -1, -1):
            pos = int(scan[c])
            row, col = pos // cw, pos % cw
            level = int(abs(coeffs[c]))
            if c == eob - 1:
                ctx = lvmap.coeff_base_eob_ctx(c, eob, area)
                self._sym(
                    w, min(level, 3) - 1,
                    self.fc.coeff_base_eob_cdf, txs_ctx, plane_type, ctx,
                )
            else:
                ctx = lvmap.coeff_base_ctx(levels, row, col, cw, ch, cls)
                self._sym(
                    w, min(level, 3),
                    self.fc.coeff_base_cdf, txs_ctx, plane_type, ctx,
                )
            if level > lvmap.NUM_BASE_LEVELS:
                base_range = level - 1 - lvmap.NUM_BASE_LEVELS
                bctx = lvmap.br_ctx(levels, row, col, cls)
                idx = 0
                while idx < lvmap.COEFF_BASE_RANGE:
                    k = min(base_range - idx, lvmap.BR_CDF_SIZE - 1)
                    self._sym(
                        w, k,
                        self.fc.coeff_br_cdf,
                        min(txs_ctx, int(TxSize.TX_32X32)), plane_type, bctx,
                    )
                    if k < lvmap.BR_CDF_SIZE - 1:
                        break
                    idx += lvmap.BR_CDF_SIZE - 1

        # signs + golomb residue (in forward scan order)
        cul_level = int(np.abs(coeffs).sum())
        for c in range(eob):
            v = int(coeffs[c])
            if v == 0:
                continue
            level = abs(v)
            sign = int(v < 0)
            if c == 0:
                self._sym(w, sign, self.fc.dc_sign_cdf, plane_type, dc_sign_ctx)
            else:
                w.bit(sign)
            if level > lvmap.COEFF_BASE_RANGE + lvmap.NUM_BASE_LEVELS:
                w.write_golomb(level - lvmap.COEFF_BASE_RANGE - lvmap.NUM_BASE_LEVELS - 1)

        cul_level = min(COEFF_CONTEXT_MASK, cul_level)
        dc_val = int(coeffs[0])
        if dc_val < 0:
            cul_level |= 1 << COEFF_CONTEXT_BITS
        elif dc_val > 0:
            cul_level += 2 << COEFF_CONTEXT_BITS
        self.bc.store_coeff_context(plane, x, y, tx_size, xdec, ydec, cul_level)
        return True


def cfl_allowed(bsize: BlockSize) -> bool:
    """CFL allowed for blocks <= 32x32 (spec)."""
    return bsize.width <= 32 and bsize.height <= 32


# ---------------------------------------------------------------------------
# Loop restoration signaling (reference context/frame_header.rs:171-270,
# ec.rs:656-760; spec 5.11.57 read_lr_unit / 4.10.x subexp decoding)
# ---------------------------------------------------------------------------


def _recenter(r: int, v: int) -> int:
    if v > (r << 1):
        return v
    if v >= r:
        return (v - r) << 1
    return ((r - v) << 1) - 1


def _w_quniform(w, n: int, v: int) -> None:
    if n > 1:
        l = n.bit_length()
        m = (1 << l) - n
        if v < m:
            w.literal(l - 1, v)
        else:
            w.literal(l - 1, m + ((v - m) >> 1))
            w.literal(1, (v - m) & 1)


def _w_subexp(w, n: int, k: int, v: int) -> None:
    i = 0
    mk = 0
    while True:
        b = k + i - 1 if i else k
        a = 1 << b
        if n <= mk + 3 * a:
            _w_quniform(w, n - mk, v - mk)
            break
        t = v >= mk + a
        w.literal(1, int(t))
        if t:
            i += 1
            mk += a
        else:
            w.literal(b, v - mk)
            break


def write_signed_subexp_with_ref(w, v: int, low: int, high: int, k: int, r: int) -> None:
    v -= low
    r -= low
    n = high - low
    if (r << 1) <= n:
        _w_subexp(w, n, k, _recenter(r, v))
    else:
        _w_subexp(w, n, k, _recenter(n - 1 - r, n - 1 - v))


def _lrf_write_methods():
    from encbench.reference.av1.ops import lrf as LRF

    def write_lrf(self, w, rs, refs, sb_x: int, sb_y: int, pli: int) -> None:
        """Code the LRU filter when this SB is the first to touch it."""
        rp = rs.planes[pli]
        if rp.cfg.lrf_type == LRF.RESTORE_NONE:
            return
        idx = rp.unit_index(sb_x, sb_y, True)
        if idx is None:
            return
        ux, uy = idx
        countable = uy * rp.cfg.cols + ux
        if countable <= refs.last_coded[pli]:
            return
        refs.last_coded[pli] = countable
        filt = rp.units[uy][ux]
        t = rp.cfg.lrf_type
        if filt[0] == "none":
            if t == LRF.RESTORE_WIENER:
                self._sym(w, 0, self.fc.lrf_wiener_cdf)
            elif t == LRF.RESTORE_SGRPROJ:
                self._sym(w, 0, self.fc.lrf_sgrproj_cdf)
            else:
                self._sym(w, 0, self.fc.lrf_switchable_cdf)
        elif filt[0] == "sgr":
            sgr_set, xqd = filt[1], filt[2]
            if t == LRF.RESTORE_SGRPROJ:
                self._sym(w, 1, self.fc.lrf_sgrproj_cdf)
            else:
                self._sym(w, 2, self.fc.lrf_switchable_cdf)
            w.literal(LRF.SGRPROJ_PARAMS_BITS, sgr_set)
            for i in range(2):
                if LRF.SGRPROJ_PARAMS_S[sgr_set][i] > 0:
                    write_signed_subexp_with_ref(
                        w, int(xqd[i]), LRF.SGRPROJ_XQD_MIN[i],
                        LRF.SGRPROJ_XQD_MAX[i] + 1, LRF.SGRPROJ_PRJ_SUBEXP_K,
                        refs.sgrproj_ref[pli][i],
                    )
                    refs.sgrproj_ref[pli][i] = int(xqd[i])
                else:
                    refs.sgrproj_ref[pli][i] = 0 if i == 0 else 95
        else:  # wiener
            coeffs = filt[1]
            if t == LRF.RESTORE_WIENER:
                self._sym(w, 1, self.fc.lrf_wiener_cdf)
            else:
                self._sym(w, 1, self.fc.lrf_switchable_cdf)
            for p in range(2):
                first = 0 if pli == 0 else 1
                for i in range(first, 3):
                    write_signed_subexp_with_ref(
                        w, int(coeffs[p][i]), LRF.WIENER_TAPS_MIN[i],
                        LRF.WIENER_TAPS_MAX[i] + 1, i + 1,
                        refs.wiener_ref[pli][p][i],
                    )
                    refs.wiener_ref[pli][p][i] = int(coeffs[p][i])

    ContextWriter.write_lrf = write_lrf


_lrf_write_methods()


def _segmentation_methods():
    from encbench.reference.av1.encoder.segmentation import neg_interleave

    def get_segment_pred(self, x: int, y: int, last_active: int):
        """(partition_unit.rs:204-247)"""
        b = self.bc.blocks
        prev_ul = int(b.segmentation_idx[y - 1, x - 1]) if x > 0 and y > 0 else -1
        prev_u = int(b.segmentation_idx[y - 1, x]) if y > 0 else -1
        prev_l = int(b.segmentation_idx[y, x - 1]) if x > 0 else -1
        if prev_ul < 0 or prev_u < 0 or prev_l < 0:
            cdf_index = 0
        elif prev_ul == prev_u and prev_ul == prev_l:
            cdf_index = 2
        elif prev_ul == prev_u or prev_ul == prev_l or prev_u == prev_l:
            cdf_index = 1
        else:
            cdf_index = 0
        if prev_u == -1:
            r = 0 if prev_l == -1 else prev_l
        elif prev_l == -1:
            r = prev_u
        else:
            r = prev_u if prev_ul == prev_u else prev_l
        return min(r, last_active), cdf_index

    def write_segmentation(self, w, x, y, bsize, skip, last_active, seg_id):
        """(partition_unit.rs:388-410); stores the id for neighbor preds."""
        pred, cdf_index = self.get_segment_pred(x, y, last_active)
        if skip:
            self.bc.blocks.set_rect("segmentation_idx", x, y, bsize, pred)
            return pred
        coded = neg_interleave(int(seg_id), pred, last_active + 1)
        self._sym(w, coded, self.fc.spatial_segmentation_cdfs, cdf_index)
        self.bc.blocks.set_rect("segmentation_idx", x, y, bsize, int(seg_id))
        return int(seg_id)

    ContextWriter.get_segment_pred = get_segment_pred
    ContextWriter.write_segmentation = write_segmentation


_segmentation_methods()


def _compound_methods():
    from encbench.reference.av1.context import mv as MV

    def _comp_neighbors(self, x, y):
        b = self.bc.blocks
        if x > 0:
            left = (int(b.ref_frames[y, x - 1, 0]), int(b.ref_frames[y, x - 1, 1]))
        else:
            left = (0, -1)  # (INTRA_FRAME, NONE_FRAME)
        if y > 0:
            above = (int(b.ref_frames[y - 1, x, 0]), int(b.ref_frames[y - 1, x, 1]))
        else:
            above = (0, -1)
        return above, left

    def get_comp_mode_ctx(self, x, y):
        """(block_unit.rs:1533-1582)"""
        avail_left = x > 0
        avail_up = y > 0
        (above0, above1), (left0, left1) = self._comp_neighbors(x, y)
        left_single = left1 == -1
        above_single = above1 == -1
        left_intra = left0 == 0
        above_intra = above0 == 0
        left_backward = MV.is_bwd_ref(left0)
        above_backward = MV.is_bwd_ref(above0)
        if avail_left and avail_up:
            if above_single and left_single:
                return int(above_backward != left_backward)
            if above_single:
                return 2 + int(above_backward or above_intra)
            if left_single:
                return 2 + int(left_backward or left_intra)
            return 4
        if avail_up:
            return int(above_backward) if above_single else 3
        if avail_left:
            return int(left_backward) if left_single else 3
        return 1

    def get_comp_ref_type_ctx(self, x, y):
        """(block_unit.rs:1584-1658)"""

        def samedir(r0, r1):
            return (MV.is_bwd_ref(r0) and r0 != -1) == (MV.is_bwd_ref(r1) and r1 != -1)

        avail_left = x > 0
        avail_up = y > 0
        (above0, above1), (left0, left1) = self._comp_neighbors(x, y)
        left_single = left1 == -1
        above_single = above1 == -1
        left_intra = left0 == 0
        above_intra = above0 == 0
        above_comp_inter = avail_up and not above_intra and not above_single
        left_comp_inter = avail_left and not left_intra and not left_single
        above_uni_comp = above_comp_inter and samedir(above0, above1)
        left_uni_comp = left_comp_inter and samedir(left0, left1)

        if avail_up and not above_intra and avail_left and not left_intra:
            sd = int(samedir(above0, left0))
            if not above_comp_inter and not left_comp_inter:
                return 1 + 2 * sd
            if not above_comp_inter:
                return 1 if not left_uni_comp else 3 + sd
            if not left_comp_inter:
                return 1 if not above_uni_comp else 3 + sd
            if not above_uni_comp and not left_uni_comp:
                return 0
            if not above_uni_comp or not left_uni_comp:
                return 2
            return 3 + int((above0 == MV.BWDREF_FRAME) == (left0 == MV.BWDREF_FRAME))
        if avail_up and avail_left:
            if above_comp_inter:
                return 1 + 2 * int(above_uni_comp)
            if left_comp_inter:
                return 1 + 2 * int(left_uni_comp)
            return 2
        if above_comp_inter:
            return 4 * int(above_uni_comp)
        if left_comp_inter:
            return 4 * int(left_uni_comp)
        return 2

    def write_comp_mode(self, w, x, y, is_compound: bool) -> None:
        """comp_mode bit under reference_mode SELECT (frame_header.rs:76-81)."""
        ctx = self.get_comp_mode_ctx(x, y)
        self._sym(w, int(is_compound), self.fc.comp_mode_cdf, ctx)

    def write_ref_frames_compound(self, w, x, y, counts) -> None:
        """Bidir LAST+ALTREF pair (frame_header.rs:85-120)."""
        rctx = MV.ref_count_ctx
        # comp_ref_type = 1 (bidir)
        self._sym(w, 1, self.fc.comp_ref_type_cdf, self.get_comp_ref_type_ctx(x, y))
        # fwd: LAST group (not LAST3/GOLDEN), then LAST (not LAST2)
        ctx = rctx(counts[0] + counts[1], counts[2] + counts[3])
        self._sym(w, 0, self.fc.comp_ref_cdf, ctx, 0)
        ctx = rctx(counts[0], counts[1])
        self._sym(w, 0, self.fc.comp_ref_cdf, ctx, 1)
        # bwd: ALTREF
        ctx = rctx(counts[4] + counts[5], counts[6])
        self._sym(w, 1, self.fc.comp_bwd_ref_cdf, ctx, 0)

    def write_compound_mode(self, w, mode, ctx: int) -> None:
        """(block_unit.rs:1660-1693)"""
        newmv_ctx = ctx & MV.NEWMV_CTX_MASK
        refmv_ctx = (ctx >> MV.REFMV_OFFSET) & MV.REFMV_CTX_MASK
        if refmv_ctx < 2:
            cctx = min(newmv_ctx, 1)
        elif refmv_ctx < 4:
            cctx = min(newmv_ctx + 1, 4)
        else:
            cctx = min(max(newmv_ctx, 1) + 3, 7)
        val = {
            PredictionMode.NEAREST_NEARESTMV: 0,
            PredictionMode.NEAR_NEAR0MV: 1,
            PredictionMode.NEAR_NEAR1MV: 1,
            PredictionMode.NEAR_NEAR2MV: 1,
            PredictionMode.NEAREST_NEWMV: 2,
            PredictionMode.NEW_NEARESTMV: 3,
            PredictionMode.GLOBAL_GLOBALMV: 6,
            PredictionMode.NEW_NEWMV: 7,
        }[mode]
        self._sym(w, val, self.fc.compound_mode_cdf, cctx)

    ContextWriter._comp_neighbors = _comp_neighbors
    ContextWriter.get_comp_mode_ctx = get_comp_mode_ctx
    ContextWriter.get_comp_ref_type_ctx = get_comp_ref_type_ctx
    ContextWriter.write_comp_mode = write_comp_mode
    ContextWriter.write_ref_frames_compound = write_ref_frames_compound
    ContextWriter.write_compound_mode = write_compound_mode


_compound_methods()
