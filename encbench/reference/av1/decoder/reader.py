"""ContextReader: symbol-decoding mirror of ContextWriter.

Shares every context derivation with the encoder (BlockContext, lvmap,
scans, CDFContext) — only the direction of the symbol coder differs.
"""

from __future__ import annotations

import numpy as np

from encbench.reference.av1.context import lvmap
from encbench.reference.av1.context.block import (
    COEFF_CONTEXT_BITS,
    COEFF_CONTEXT_MASK,
    BlockContext,
)
from encbench.reference.av1.context.cdf import CDFContext
from encbench.reference.av1.context.writer import (
    AV1_TX_IND,
    INTRA_MODE_CONTEXT,
    MAX_TXSIZE_RECT,
    NUM_TX_SET,
    SIZE_GROUP_LOOKUP,
    SUB_TX_SIZE_MAP,
    TX_SET_INDEX_INTER,
    TX_SET_INDEX_INTRA,
    MAX_ANGLE_DELTA,
    cfl_allowed,
)
from encbench.reference.av1.ec import Reader, update_cdf
from encbench.reference.av1.partition import BlockSize, PartitionType, PredictionMode
from encbench.reference.av1.quantize import _scan_kind
from encbench.reference.av1.tables import scan_order
from encbench.reference.av1.tx import TxSize, TxType, get_tx_set
from encbench.reference.av1.utils import desync


def _base_ctx(lv, stride: int, row: int, col: int, w: int, h: int, cls: int) -> int:
    """lvmap.coeff_base_ctx on a flat list of levels ``stride`` wide."""
    if cls == lvmap.TX_CLASS_2D and row == 0 and col == 0:
        return 0
    i = row * stride + col
    a, b = lv[i + 1], lv[i + stride]
    m = (a if a < 3 else 3) + (b if b < 3 else 3)
    if cls == lvmap.TX_CLASS_2D:
        taps = (lv[i + stride + 1], lv[i + 2], lv[i + 2 * stride])
    elif cls == lvmap.TX_CLASS_VERT:
        taps = (lv[i + 2 * stride], lv[i + 3 * stride], lv[i + 4 * stride])
    else:  # HORIZ
        taps = (lv[i + 2], lv[i + 3], lv[i + 4])
    for t in taps:
        m += t if t < 3 else 3
    ctx = min((m + 1) >> 1, 4)
    if cls == lvmap.TX_CLASS_2D:
        if w < h and row < 2:
            return 11 + ctx
        if w > h and col < 2:
            return 16 + ctx
        if row + col < 2:
            return ctx + 1
        if row + col < 4:
            return 5 + ctx + 1
        return 21 + ctx
    pos = col if cls == lvmap.TX_CLASS_HORIZ else row
    return 26 + (0 if pos == 0 else (5 if pos == 1 else 10)) + ctx


def _br_ctx(lv, stride: int, row: int, col: int, cls: int) -> int:
    """lvmap.br_ctx on a flat list of levels ``stride`` wide."""
    i = row * stride + col
    m = lv[i + 1] + lv[i + stride]
    if cls == lvmap.TX_CLASS_2D:
        m += lv[i + stride + 1]
        m = min((m + 1) >> 1, 6)
        if row == 0 and col == 0:
            return m
        if row < 2 and col < 2:
            return m + 7
    elif cls == lvmap.TX_CLASS_HORIZ:
        m += lv[i + 2]
        m = min((m + 1) >> 1, 6)
        if row == 0 and col == 0:
            return m
        if col == 0:
            return m + 7
    else:
        m += lv[i + 2 * stride]
        m = min((m + 1) >> 1, 6)
        if row == 0 and col == 0:
            return m
        if row == 0:
            return m + 7
    return m + 14


class ContextReader:
    def __init__(self, fc: CDFContext, bc: BlockContext):
        self.fc = fc
        self.bc = bc

    def _sym(self, r: Reader, arr: np.ndarray, *idx) -> int:
        cdf = arr[idx].tolist()
        s = r.read_symbol(cdf)
        if desync.enabled():
            desync.log_symbol("dec", s)
        update_cdf(cdf, s)
        arr[idx] = cdf
        return s

    # --- partitions ------------------------------------------------------

    def read_partition(self, r: Reader, x: int, y: int, bsize: BlockSize) -> PartitionType:
        from encbench.reference.av1.context.writer import ContextWriter

        hbs = bsize.width_mi // 2
        has_cols = (x + hbs) < self.bc.blocks.cols
        has_rows = (y + hbs) < self.bc.blocks.rows
        ctx = self.bc.partition_plane_context(x, y, bsize)
        if not has_rows and not has_cols:
            return PartitionType.PARTITION_SPLIT
        if ctx < 4:
            arr, aidx = self.fc.partition_w8_cdf, ctx
        elif ctx < 16:
            arr, aidx = self.fc.partition_cdf, ctx - 4
        else:
            arr, aidx = self.fc.partition_w128_cdf, ctx - 16
        if has_rows and has_cols:
            return PartitionType(self._sym(r, arr, aidx))
        cdf_in = arr[aidx].tolist()
        if not has_rows:
            g = ContextWriter._gather_split_prob(cdf_in, vert_alike=True)
            split = r.read_symbol(list(g)) == 1
            return PartitionType.PARTITION_SPLIT if split else PartitionType.PARTITION_HORZ
        else:
            g = ContextWriter._gather_split_prob(cdf_in, vert_alike=False)
            split = r.read_symbol(list(g)) == 1
            return PartitionType.PARTITION_SPLIT if split else PartitionType.PARTITION_VERT

    # --- modes -----------------------------------------------------------

    def read_skip(self, r: Reader, x: int, y: int) -> bool:
        ctx = self.bc.skip_context(x, y)
        return self._sym(r, self.fc.skip_cdfs, ctx) == 1

    def _skip_mode_at(self, x: int, y: int) -> bool:
        from encbench.reference.av1.partition import PredictionMode

        b = self.bc.blocks
        return (
            bool(b.is_inter_flag[y, x])
            and int(b.mode[y, x]) == int(PredictionMode.NEAREST_NEARESTMV)
            and bool(b.skip[y, x])
            and int(b.ref_frames[y, x, 1]) > 0
        )

    def read_skip_mode(self, r: Reader, x: int, y: int) -> bool:
        ctx = int(y > 0 and self._skip_mode_at(x, y - 1)) + int(
            x > 0 and self._skip_mode_at(x - 1, y)
        )
        return self._sym(r, self.fc.skip_mode_cdfs, ctx) == 1

    def read_intra_mode_kf(self, r: Reader, x: int, y: int) -> PredictionMode:
        above = int(self.bc.blocks.mode[y - 1, x]) if y > 0 else 0
        left = int(self.bc.blocks.mode[y, x - 1]) if x > 0 else 0
        s = self._sym(r, self.fc.kf_y_cdf, INTRA_MODE_CONTEXT[above], INTRA_MODE_CONTEXT[left])
        return PredictionMode(s)

    def read_intra_mode(self, r: Reader, bsize: BlockSize) -> PredictionMode:
        return PredictionMode(self._sym(r, self.fc.y_mode_cdf, SIZE_GROUP_LOOKUP[int(bsize)]))

    def read_intra_uv_mode(self, r: Reader, y_mode: PredictionMode, bsize: BlockSize) -> PredictionMode:
        if cfl_allowed(bsize):
            return PredictionMode(self._sym(r, self.fc.uv_mode_cfl_cdf, int(y_mode)))
        return PredictionMode(self._sym(r, self.fc.uv_mode_cdf, int(y_mode)))

    def read_angle_delta(self, r: Reader, mode: PredictionMode) -> int:
        s = self._sym(
            r, self.fc.angle_delta_cdf, int(mode) - int(PredictionMode.V_PRED)
        )
        return s - MAX_ANGLE_DELTA

    def read_cfl_alphas(self, r: Reader):
        joint_sign = self._sym(r, self.fc.cfl_sign_cdf)
        sign_u = (joint_sign + 1) // 3
        sign_v = (joint_sign + 1) % 3
        u_idx = v_idx = 0
        if sign_u != 0:
            u_idx = self._sym(r, self.fc.cfl_alpha_cdf, (sign_u - 1) * 3 + sign_v)
        if sign_v != 0:
            v_idx = self._sym(r, self.fc.cfl_alpha_cdf, (sign_v - 1) * 3 + sign_u)
        alpha_u = [0, -1, 1][sign_u] * (u_idx + 1)
        alpha_v = [0, -1, 1][sign_v] * (v_idx + 1)
        return alpha_u, alpha_v

    def read_use_filter_intra(self, r: Reader, bsize: BlockSize) -> bool:
        return self._sym(r, self.fc.filter_intra_cdfs, int(bsize)) == 1

    def read_tx_size_intra(self, r: Reader, x: int, y: int, bsize: BlockSize) -> TxSize:
        from encbench.reference.av1.context.writer import ContextWriter

        # share the context derivation
        cw = ContextWriter.__new__(ContextWriter)
        cw.fc, cw.bc = self.fc, self.bc
        tx_size_ctx = ContextWriter._get_tx_size_context(cw, x, y, bsize)

        max_tx = MAX_TXSIZE_RECT[int(bsize)]

        def cat(bs):
            t = MAX_TXSIZE_RECT[int(bs)]
            depth = 0
            while t != TxSize.TX_4X4:
                depth += 1
                t = SUB_TX_SIZE_MAP[int(t)]
            return depth - 1

        c = cat(bsize)
        if c > 0:
            depth = self._sym(r, self.fc.tx_size_cdf, c - 1, tx_size_ctx)
        else:
            depth = self._sym(r, self.fc.tx_size_8x8_cdf, tx_size_ctx)
        t = max_tx
        for _ in range(depth):
            t = SUB_TX_SIZE_MAP[int(t)]
        return t

    def read_tx_type(
        self, r: Reader, tx_size: TxSize, y_mode: PredictionMode,
        is_inter: bool, use_reduced_tx_set: bool,
    ) -> TxType:
        tx_set = get_tx_set(tx_size, is_inter, use_reduced_tx_set)
        if NUM_TX_SET[int(tx_set)] <= 1:
            return TxType.DCT_DCT
        square = int(tx_size.sqr())
        if is_inter:
            idx = TX_SET_INDEX_INTER[int(tx_set)]
            if idx == 1:
                s = self._sym(r, self.fc.inter_tx_1_cdf, square)
            elif idx == 2:
                s = self._sym(r, self.fc.inter_tx_2_cdf, square)
            else:
                s = self._sym(r, self.fc.inter_tx_3_cdf, square)
        else:
            idx = TX_SET_INDEX_INTRA[int(tx_set)]
            if idx == 1:
                s = self._sym(r, self.fc.intra_tx_1_cdf, square, int(y_mode))
            else:
                s = self._sym(r, self.fc.intra_tx_2_cdf, square, int(y_mode))
        # invert AV1_TX_IND for this set
        ind = AV1_TX_IND[int(tx_set)]
        from encbench.reference.av1.context.writer import ContextWriter  # noqa: F401

        # members of the set are where av1_tx_used is 1; find tx with ind==s
        from encbench.reference.av1.tx import TX_SET_MEMBERS, TxSet

        members = _tx_set_members(tx_set)
        for t in members:
            if ind[int(t)] == s:
                return t
        raise ValueError("invalid tx type symbol")

    # --- inter modes ------------------------------------------------------

    def read_is_inter(self, r: Reader, x: int, y: int) -> bool:
        from encbench.reference.av1.context.writer import ContextWriter

        cw = ContextWriter.__new__(ContextWriter)
        cw.fc, cw.bc = self.fc, self.bc
        ctx = ContextWriter._intra_inter_context(cw, x, y)
        return self._sym(r, self.fc.intra_inter_cdfs, ctx) == 1

    def read_ref_frames_single(self, r: Reader, counts) -> int:
        from encbench.reference.av1.context import mv as MV

        rctx = MV.ref_count_ctx
        fwd = counts[0] + counts[1] + counts[2] + counts[3]
        bwd = counts[4] + counts[5] + counts[6]
        b0 = self._sym(r, self.fc.single_ref_cdfs, rctx(fwd, bwd), 0) == 1
        if b0:
            ctx = rctx(counts[4] + counts[5], counts[6])
            if self._sym(r, self.fc.single_ref_cdfs, ctx, 1) == 1:
                return MV.ALTREF_FRAME
            if self._sym(r, self.fc.single_ref_cdfs, rctx(counts[4], counts[5]), 5) == 1:
                return MV.ALTREF2_FRAME
            return MV.BWDREF_FRAME
        ctx = rctx(counts[0] + counts[1], counts[2] + counts[3])
        if self._sym(r, self.fc.single_ref_cdfs, ctx, 2) == 1:
            if self._sym(r, self.fc.single_ref_cdfs, rctx(counts[2], counts[3]), 4) == 1:
                return MV.GOLDEN_FRAME
            return MV.LAST3_FRAME
        if self._sym(r, self.fc.single_ref_cdfs, rctx(counts[0], counts[1]), 3) == 1:
            return MV.LAST2_FRAME
        return MV.LAST_FRAME

    def read_inter_mode(self, r: Reader, ctx: int) -> PredictionMode:
        from encbench.reference.av1.context.mv import (
            GLOBALMV_CTX_MASK,
            GLOBALMV_OFFSET,
            NEWMV_CTX_MASK,
            REFMV_CTX_MASK,
            REFMV_OFFSET,
        )

        if self._sym(r, self.fc.newmv_cdf, ctx & NEWMV_CTX_MASK) == 0:
            return PredictionMode.NEWMV
        if self._sym(r, self.fc.zeromv_cdf, (ctx >> GLOBALMV_OFFSET) & GLOBALMV_CTX_MASK) == 0:
            return PredictionMode.GLOBALMV
        if self._sym(r, self.fc.refmv_cdf, (ctx >> REFMV_OFFSET) & REFMV_CTX_MASK) == 0:
            return PredictionMode.NEARESTMV
        return PredictionMode.NEAR0MV

    def read_drl_mode(self, r: Reader, ctx: int) -> bool:
        return self._sym(r, self.fc.drl_cdfs, ctx) == 1

    def read_mv(self, r: Reader, ref_mv, precision: int):
        j = self._sym(r, self.fc.nmv_joints_cdf)
        drow = self._read_mv_component(r, 0, precision) if (j >> 1) & 1 else 0
        dcol = self._read_mv_component(r, 1, precision) if j & 1 else 0
        return (ref_mv[0] + drow, ref_mv[1] + dcol)

    def _read_mv_component(self, r: Reader, axis: int, precision: int) -> int:
        sign = self._sym(r, self.fc.nmv_sign_cdf, axis)
        mv_class = self._sym(r, self.fc.nmv_classes_cdf, axis)
        if mv_class == 0:
            d = self._sym(r, self.fc.nmv_class0_cdf, axis)
        else:
            d = 0
            for i in range(mv_class):
                d |= self._sym(r, self.fc.nmv_bits_cdf, axis, i) << i
        if precision > 0:
            if mv_class == 0:
                fr = self._sym(r, self.fc.nmv_class0_fp_cdf, axis, d)
            else:
                fr = self._sym(r, self.fc.nmv_fp_cdf, axis)
        else:
            fr = 3
        if precision > 1:
            if mv_class == 0:
                hp = self._sym(r, self.fc.nmv_class0_hp_cdf, axis)
            else:
                hp = self._sym(r, self.fc.nmv_hp_cdf, axis)
        else:
            hp = 1
        base = 0 if mv_class == 0 else (2 << (mv_class + 2))
        mag = base + (d << 3) + (fr << 1) + hp + 1
        return -mag if sign else mag

    def read_tx_size_inter(self, r: Reader, x: int, y: int, bsize: BlockSize, tx_size: TxSize, tbx: int, tby: int, depth: int) -> "TxSize":
        """Mirror of write_tx_size_inter; returns the leaf tx size (uniform
        trees only — matching the encoder's whole-block split decision)."""
        from encbench.reference.av1.context.writer import SUB_TX_SIZE_MAP, ContextWriter

        if x >= self.bc.blocks.cols or y >= self.bc.blocks.rows:
            return tx_size
        cw = ContextWriter.__new__(ContextWriter)
        cw.fc, cw.bc = self.fc, self.bc
        split = False
        if tx_size != TxSize.TX_4X4 and depth < 2:
            ctx = ContextWriter._txfm_partition_context(cw, x, y, bsize, tx_size, tbx, tby)
            split = self._sym(r, self.fc.txfm_partition_cdf, ctx) == 1
        if not split:
            self.bc.update_tx_size_context(
                x, y, BlockSize.from_wh(tx_size.width, tx_size.height), tx_size, False
            )
            return tx_size
        sub = SUB_TX_SIZE_MAP[int(tx_size)]
        bw = bsize.width_mi // max(sub.width >> 2, 1)
        bh = bsize.height_mi // max(sub.height >> 2, 1)
        leaf = sub
        for by in range(bh):
            for bx in range(bw):
                leaf = self.read_tx_size_inter(
                    r, x + bx * (sub.width >> 2), y + by * (sub.height >> 2),
                    bsize, sub, bx, by, depth + 1,
                )
        return leaf

    # --- coefficients -----------------------------------------------------

    def read_coeffs_lv_map(
        self,
        r: Reader,
        plane: int,
        x: int,
        y: int,
        pred_mode: PredictionMode,
        tx_size: TxSize,
        uv_tx_type: TxType,
        plane_bsize: BlockSize,
        xdec: int,
        ydec: int,
        use_reduced_tx_set: bool,
        frame_clipped_txw: int,
        frame_clipped_txh: int,
    ):
        """Returns (qcoeffs (H,W) int32, eob, tx_type).

        For chroma (plane > 0) ``uv_tx_type`` supplies the (derived, not
        coded) transform type; for luma it is read from the stream.
        """
        is_inter = not pred_mode.is_intra()
        txs_ctx = lvmap.txsize_entropy_ctx(tx_size)
        txb_skip_ctx, dc_sign_ctx = self.bc.get_txb_ctx(
            plane_bsize, tx_size, plane, x, y, xdec, ydec,
            frame_clipped_txw, frame_clipped_txh,
        )
        plane_type = int(plane != 0)
        qcoeffs = np.zeros((tx_size.height, tx_size.width), dtype=np.int32)

        all_zero = self._sym(r, self.fc.txb_skip_cdf, txs_ctx, txb_skip_ctx) == 1
        if all_zero:
            self.bc.store_coeff_context(plane, x, y, tx_size, xdec, ydec, 0)
            return qcoeffs, 0, TxType.DCT_DCT

        if plane == 0:
            tx_type = self.read_tx_type(r, tx_size, pred_mode, is_inter, use_reduced_tx_set)
        else:
            tx_type = uv_tx_type
        return self._read_coeffs_rest(
            r, plane, x, y, tx_size, tx_type, dc_sign_ctx, txs_ctx, plane_type, xdec, ydec, qcoeffs
        )

    def _read_coeffs_rest(
        self, r, plane, x, y, tx_size, tx_type, dc_sign_ctx, txs_ctx, plane_type, xdec, ydec, qcoeffs
    ):
        cw, ch = lvmap.coded_dims(tx_size)
        cls = lvmap.tx_class(tx_type)
        scan = scan_order(cw, ch, _scan_kind(tx_type))
        area = cw * ch

        # EOB position
        eob_multi_size = tx_size.width_log2 + tx_size.height_log2 - 4
        eob_multi_ctx = int(cls != lvmap.TX_CLASS_2D)
        eob_cdf_arr = [
            self.fc.eob_flag_cdf16, self.fc.eob_flag_cdf32, self.fc.eob_flag_cdf64,
            self.fc.eob_flag_cdf128, self.fc.eob_flag_cdf256, self.fc.eob_flag_cdf512,
            self.fc.eob_flag_cdf1024,
        ][min(eob_multi_size, 6)]
        eob_pt = self._sym(r, eob_cdf_arr, plane_type, eob_multi_ctx) + 1
        eob = lvmap.K_EOB_GROUP_START[eob_pt]
        offset_bits = lvmap.K_EOB_OFFSET_BITS[eob_pt]
        if offset_bits > 0:
            bit = self._sym(r, self.fc.eob_extra_cdf, txs_ctx, plane_type, eob_pt - 3)
            extra = bit << (offset_bits - 1)
            for i in range(1, offset_bits):
                extra |= r.read_bit() << (offset_bits - 1 - i)
            eob += extra

        # the levels as a flat list of rows cw + 4 wide (lvmap's padded
        # array), read by _base_ctx and _br_ctx
        stride = cw + 4
        levels = [0] * ((ch + 4) * stride)
        flat_levels = np.zeros(area, dtype=np.int64)
        scan_l = scan.tolist()

        for c in range(eob - 1, -1, -1):
            pos = scan_l[c]
            row, col = pos // cw, pos % cw
            if c == eob - 1:
                ctx = lvmap.coeff_base_eob_ctx(c, eob, area)
                level = self._sym(r, self.fc.coeff_base_eob_cdf, txs_ctx, plane_type, ctx) + 1
            else:
                ctx = _base_ctx(levels, stride, row, col, cw, ch, cls)
                level = self._sym(r, self.fc.coeff_base_cdf, txs_ctx, plane_type, ctx)
            if level > lvmap.NUM_BASE_LEVELS:
                bctx = _br_ctx(levels, stride, row, col, cls)
                idx = 0
                while idx < lvmap.COEFF_BASE_RANGE:
                    k = self._sym(
                        r, self.fc.coeff_br_cdf,
                        min(txs_ctx, int(TxSize.TX_32X32)), plane_type, bctx,
                    )
                    level += k
                    if k < lvmap.BR_CDF_SIZE - 1:
                        break
                    idx += lvmap.BR_CDF_SIZE - 1
            levels[row * stride + col] = min(level, 127)
            flat_levels[pos] = level

        # signs + golomb residue
        cul_level = 0
        signs = np.zeros(area, dtype=np.int64)
        for c in range(eob):
            pos = int(scan[c])
            level = int(flat_levels[pos])
            if level == 0:
                continue
            if c == 0:
                sign = self._sym(r, self.fc.dc_sign_cdf, plane_type, dc_sign_ctx)
            else:
                sign = r.read_bit()
            if level > lvmap.COEFF_BASE_RANGE + lvmap.NUM_BASE_LEVELS:
                level = (
                    r.read_golomb() + lvmap.COEFF_BASE_RANGE + lvmap.NUM_BASE_LEVELS + 1
                )
                flat_levels[pos] = level
            signs[pos] = sign
            cul_level += level

        vals = np.where(signs == 1, -flat_levels, flat_levels)
        qcoeffs[:ch, :cw] = vals.reshape(ch, cw).astype(np.int32)

        cul_level = min(COEFF_CONTEXT_MASK, cul_level)
        dc_val = int(qcoeffs[0, 0])
        if dc_val < 0:
            cul_level |= 1 << COEFF_CONTEXT_BITS
        elif dc_val > 0:
            cul_level += 2 << COEFF_CONTEXT_BITS
        self.bc.store_coeff_context(plane, x, y, tx_size, xdec, ydec, cul_level)
        return qcoeffs, eob, tx_type


def _tx_set_members(tx_set):
    from encbench.reference.av1.tx import TX_SET_MEMBERS

    return TX_SET_MEMBERS[tx_set]


def _lrf_read_method():
    from encbench.reference.av1.ops import lrf as LRF

    def read_lrf(self, r, rs, refs, sb_x: int, sb_y: int, pli: int) -> None:
        """Mirror of ContextWriter.write_lrf: parse the LRU filter when this
        SB is the first to touch it, storing it into rs.planes[pli].units."""
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
        t = rp.cfg.lrf_type
        if t == LRF.RESTORE_SWITCHABLE:
            kind = self._sym(r, self.fc.lrf_switchable_cdf)
        elif t == LRF.RESTORE_WIENER:
            kind = 1 if self._sym(r, self.fc.lrf_wiener_cdf) else 0
        else:  # RESTORE_SGRPROJ
            kind = 2 if self._sym(r, self.fc.lrf_sgrproj_cdf) else 0

        if kind == 0:
            rp.units[uy][ux] = LRF.FILTER_NONE
        elif kind == 1:  # wiener
            coeffs = [[0, 0, 0], [0, 0, 0]]
            for p in range(2):
                first = 0 if pli == 0 else 1
                for i in range(first, 3):
                    v = r.read_signed_subexp_with_ref(
                        LRF.WIENER_TAPS_MIN[i], LRF.WIENER_TAPS_MAX[i] + 1,
                        i + 1, refs.wiener_ref[pli][p][i],
                    )
                    coeffs[p][i] = v
                    refs.wiener_ref[pli][p][i] = v
            rp.units[uy][ux] = ("wiener", (tuple(coeffs[0]), tuple(coeffs[1])))
        else:  # sgrproj
            sgr_set = r.read_literal(LRF.SGRPROJ_PARAMS_BITS)
            xqd = [0, 0]
            for i in range(2):
                if LRF.SGRPROJ_PARAMS_S[sgr_set][i] > 0:
                    xqd[i] = r.read_signed_subexp_with_ref(
                        LRF.SGRPROJ_XQD_MIN[i], LRF.SGRPROJ_XQD_MAX[i] + 1,
                        LRF.SGRPROJ_PRJ_SUBEXP_K, refs.sgrproj_ref[pli][i],
                    )
                    refs.sgrproj_ref[pli][i] = xqd[i]
                else:
                    # spec: derived, not coded (frame_header.rs:222-228)
                    if i == 0:
                        xqd[0] = 0
                        refs.sgrproj_ref[pli][0] = 0
                    else:
                        xqd[1] = max(-32, min(95, (1 << LRF.SGRPROJ_PRJ_BITS) - xqd[0]))
                        refs.sgrproj_ref[pli][1] = xqd[1]
            rp.units[uy][ux] = ("sgr", sgr_set, (xqd[0], xqd[1]))

    ContextReader.read_lrf = read_lrf


_lrf_read_method()


def _segmentation_read_method():
    from encbench.reference.av1.encoder.segmentation import neg_deinterleave

    def read_segmentation(self, r, x, y, bsize, skip, last_active) -> int:
        from encbench.reference.av1.context.writer import ContextWriter

        cw = ContextWriter.__new__(ContextWriter)
        cw.fc, cw.bc = self.fc, self.bc
        pred, cdf_index = ContextWriter.get_segment_pred(cw, x, y, last_active)
        if skip:
            self.bc.blocks.set_rect("segmentation_idx", x, y, bsize, pred)
            return pred
        coded = self._sym(r, self.fc.spatial_segmentation_cdfs, cdf_index)
        sid = neg_deinterleave(coded, pred, last_active + 1)
        self.bc.blocks.set_rect("segmentation_idx", x, y, bsize, sid)
        return sid

    ContextReader.read_segmentation = read_segmentation


_segmentation_read_method()


def _compound_read_methods():
    from encbench.reference.av1.context import mv as MV

    def _cw(self):
        from encbench.reference.av1.context.writer import ContextWriter

        cw = ContextWriter.__new__(ContextWriter)
        cw.fc, cw.bc = self.fc, self.bc
        return cw

    def read_comp_mode(self, r, x, y) -> bool:
        from encbench.reference.av1.context.writer import ContextWriter

        ctx = ContextWriter.get_comp_mode_ctx(self._cw(), x, y)
        return self._sym(r, self.fc.comp_mode_cdf, ctx) == 1

    def read_ref_frames_compound(self, r, x, y, counts):
        from encbench.reference.av1.context.writer import ContextWriter
        from encbench.reference.av1.decoder.headers import DecodeError

        rctx = MV.ref_count_ctx
        cw = self._cw()
        t = self._sym(
            r, self.fc.comp_ref_type_cdf,
            ContextWriter.get_comp_ref_type_ctx(cw, x, y),
        )
        if t == 0:
            raise DecodeError("unidirectional compound unsupported")
        ctx = rctx(counts[0] + counts[1], counts[2] + counts[3])
        b2 = self._sym(r, self.fc.comp_ref_cdf, ctx, 0)
        if b2 == 0:
            ctx = rctx(counts[0], counts[1])
            b3 = self._sym(r, self.fc.comp_ref_cdf, ctx, 1)
            rf0 = MV.LAST_FRAME if b3 == 0 else MV.LAST2_FRAME
        else:
            ctx = rctx(counts[2], counts[3])
            b4 = self._sym(r, self.fc.comp_ref_cdf, ctx, 2)
            rf0 = MV.LAST3_FRAME if b4 == 0 else MV.GOLDEN_FRAME
        ctx = rctx(counts[4] + counts[5], counts[6])
        b0 = self._sym(r, self.fc.comp_bwd_ref_cdf, ctx, 0)
        if b0:
            rf1 = MV.ALTREF_FRAME
        else:
            ctx = rctx(counts[4], counts[5])
            b1 = self._sym(r, self.fc.comp_bwd_ref_cdf, ctx, 1)
            rf1 = MV.ALTREF2_FRAME if b1 else MV.BWDREF_FRAME
        return rf0, rf1

    def read_compound_mode(self, r, ctx: int):
        from encbench.reference.av1.decoder.headers import DecodeError
        from encbench.reference.av1.partition import PredictionMode

        newmv_ctx = ctx & MV.NEWMV_CTX_MASK
        refmv_ctx = (ctx >> MV.REFMV_OFFSET) & MV.REFMV_CTX_MASK
        if refmv_ctx < 2:
            cctx = min(newmv_ctx, 1)
        elif refmv_ctx < 4:
            cctx = min(newmv_ctx + 1, 4)
        else:
            cctx = min(max(newmv_ctx, 1) + 3, 7)
        val = self._sym(r, self.fc.compound_mode_cdf, cctx)
        table = {
            0: PredictionMode.NEAREST_NEARESTMV,
            1: PredictionMode.NEAR_NEAR0MV,
            2: PredictionMode.NEAREST_NEWMV,
            3: PredictionMode.NEW_NEARESTMV,
            6: PredictionMode.GLOBAL_GLOBALMV,
            7: PredictionMode.NEW_NEWMV,
        }
        if val not in table:
            raise DecodeError(f"compound mode {val} unsupported")
        return table[val]

    ContextReader._cw = _cw
    ContextReader.read_comp_mode = read_comp_mode
    ContextReader.read_ref_frames_compound = read_ref_frames_compound
    ContextReader.read_compound_mode = read_compound_mode


_compound_read_methods()
