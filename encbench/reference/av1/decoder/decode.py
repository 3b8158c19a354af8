"""Frame decoding driver for the bundled verification decoder.

Mirrors the encoder pipeline (rav1e_tpu/encoder/pipeline.py) using the same
prediction / transform / context code; this is the self-hosted stand-in for
the reference's dav1d round-trip gate (src/test_encode_decode/) in an
environment without an external AV1 decoder.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from encbench.reference.av1.api.util import FrameType
from encbench.reference.av1.config import ChromaSampling
from encbench.reference.av1.context import BlockContext, CDFContext, FrameBlocks
from encbench.reference.av1.context.writer import MAX_TXSIZE_RECT, SUB_TX_SIZE_MAP, uv_intra_mode_to_tx_type_context
from encbench.reference.av1.decoder.headers import (
    DecodeError,
    FrameHeader,
    parse_frame_header,
    parse_obus,
    parse_sequence_header,
)
from encbench.reference.av1.decoder.reader import ContextReader
from encbench.reference.av1.ec import Reader
from encbench.reference.av1.encoder.obu import ObuType, PRIMARY_REF_NONE
from encbench.reference.av1.encoder.pipeline import MIB_SIZE, has_chroma, largest_chroma_tx_size
from encbench.reference.av1.frame import Frame
from encbench.reference.av1.ops import itx as T
from encbench.reference.av1.ops.intra import predict_intra
from encbench.reference.av1.ops.intra_edges import build_intra_edge
from encbench.reference.av1.partition import BlockSize, MI_SIZE_LOG2, PartitionType, PredictionMode
from encbench.reference.av1.quantize import dequantize
from encbench.reference.av1.tx import TxSize, TxType


class DecoderState:
    """Sequence + reference frame slots carried across packets."""

    def __init__(self, seq=None):
        self.seq = seq
        self.refs: List[Optional[Frame]] = [None] * 8
        self.cdf_refs: List[Optional[object]] = [None] * 8  # saved CDF states
        self.order_hints: List[int] = [0] * 8  # per-slot order hints


def decode_packet(data: bytes, state=None):
    """Decode one temporal unit -> (Frame, DecoderState). Raises DecodeError.

    ``state`` may be None (first packet), a prior DecoderState, or (for
    backwards compatibility) a bare Sequence.
    """
    if state is None:
        state = DecoderState()
    elif not isinstance(state, DecoderState):
        state = DecoderState(seq=state)
    obus = parse_obus(data)
    fh: Optional[FrameHeader] = None
    frame: Optional[Frame] = None
    for obu_type, payload in obus:
        if obu_type == ObuType.OBU_TEMPORAL_DELIMITER:
            continue
        elif obu_type == ObuType.OBU_SEQUENCE_HEADER:
            state.seq = parse_sequence_header(payload)
        elif obu_type == ObuType.OBU_FRAME_HEADER:
            if state.seq is None:
                raise DecodeError("frame header before sequence header")
            fh = parse_frame_header(payload, state.seq, state.order_hints)
            if fh.show_existing_frame:
                shown = state.refs[fh.frame_to_show_map_idx]
                if shown is None:
                    raise DecodeError("show_existing_frame: empty slot")
                return shown, state
        elif obu_type == ObuType.OBU_METADATA:
            continue  # display metadata (T35 etc.) — not needed for recon
        elif obu_type == ObuType.OBU_TILE_GROUP:
            if fh is None:
                raise DecodeError("tile group before frame header")
            frame = _decode_tile_group(payload, state.seq, fh, state)
        else:
            raise DecodeError(f"unsupported OBU {obu_type}")
    if frame is not None and fh is not None:
        for i in range(8):
            if (fh.refresh_frame_flags >> i) & 1:
                state.refs[i] = frame
                state.order_hints[i] = fh.order_hint
    return frame, state


def _decode_tile_group(payload: bytes, seq, fh: FrameHeader, state: "DecoderState") -> Frame:
    frame = Frame.new(fh.width, fh.height, seq.chroma_sampling, seq.bit_depth)
    # spec 5.9.8 compute_image_size: mi dims round to EVEN (8px multiples)
    mi_cols = 2 * ((fh.width + 7) >> 3)
    mi_rows = 2 * ((fh.height + 7) >> 3)
    ti = fh.tiling
    n_tiles = ti.cols * ti.rows

    # split tile payloads
    tile_data: List[bytes] = []
    if n_tiles == 1:
        tile_data.append(payload)
    else:
        from encbench.reference.av1.encoder.bitio import BitReader

        br = BitReader(payload)
        if br.read_bit():
            raise DecodeError("partial tile groups unsupported")
        br.byte_align()
        pos = br.bytes_consumed()
        for i in range(n_tiles):
            if i < n_tiles - 1:
                size = int.from_bytes(payload[pos : pos + fh.tile_size_bytes], "little") + 1
                pos += fh.tile_size_bytes
                tile_data.append(payload[pos : pos + size])
                pos += size
            else:
                tile_data.append(payload[pos:])

    ref_frame = None
    if not fh.intra_only:
        # per-RefType reference list (LAST..ALTREF -> slots, spec 6.8.2)
        ref_frame = [state.refs[fh.ref_frames[i]] for i in range(7)]
        if ref_frame[0] is None:
            raise DecodeError("missing reference frame")

    frame_blocks = FrameBlocks(mi_cols, mi_rows)
    cdef_idx_map = None
    if fh.cdef_bits > 0:
        sb_rows_f = (fh.height + 63) // 64
        sb_cols_f = (fh.width + 63) // 64
        cdef_idx_map = np.full((sb_rows_f, sb_cols_f), -1, dtype=np.int32)
    rs = None
    if any(t != 0 for t in fh.lrf_types):
        from encbench.reference.av1.ops.lrf import RestorationState

        sb_w = (mi_cols + 15) // 16
        sb_h = (mi_rows + 15) // 16
        rs = RestorationState.build(
            fh.width, fh.height, seq.chroma_sampling, fh.base_q_idx, sb_w, sb_h,
            unit_sizes=(fh.lrf_unit_size[0], fh.lrf_unit_size[1]),
            lrf_types=tuple(fh.lrf_types),
        )
    init_cdfs = None
    if fh.primary_ref_frame != PRIMARY_REF_NONE and not fh.intra_only:
        init_cdfs = state.cdf_refs[fh.ref_frames[fh.primary_ref_frame]]
        if init_cdfs is None:
            raise DecodeError("primary_ref_frame slot has no saved CDFs")
    idx = 0
    tile_cdfs = []
    for tr in range(ti.rows):
        for tc in range(ti.cols):
            tx, ty, tw, th = ti.tile_rect_mi(tc, tr, mi_cols, mi_rows)
            td = TileDecoder(
                seq, fh, frame, tx, ty, tw, th, mi_cols, mi_rows, ref_frame,
                frame_blocks, rs, cdef_idx_map, init_cdfs,
            )
            td.decode(tile_data[idx])
            tile_cdfs.append((tw * th, td.fc))
            idx += 1
    # save frame-end CDFs (largest tile) into refreshed slots
    frame_cdfs = max(tile_cdfs, key=lambda t: t[0])[1]
    for i in range(8):
        if (fh.refresh_frame_flags >> i) & 1:
            state.cdf_refs[i] = frame_cdfs

    # in-loop filters (frame-level, across tiles)
    from encbench.reference.av1.ops.deblock import deblock_filter_frame

    deblock_filter_frame(
        fh.deblock_levels, frame, frame_blocks, fh.width, fh.height,
        seq.bit_depth, seq.chroma_sampling,
    )

    deblocked_planes = None
    if rs is not None:
        deblocked_planes = [
            p.data[p.cfg.pad :, p.cfg.pad :].copy() for p in frame.planes
        ]

    if seq.enable_cdef:
        from encbench.reference.av1.ops.cdef import cdef_filter_frame

        if fh.cdef_bits > 0:
            cdef_filter_frame(
                (fh.cdef_damping, list(fh.cdef_y_strengths), list(fh.cdef_uv_strengths)),
                frame, frame_blocks, seq.bit_depth, seq.chroma_sampling,
                fh.width, fh.height, cdef_idx_map=cdef_idx_map,
            )
        else:
            cdef_filter_frame(
                (fh.cdef_damping, fh.cdef_y_strengths[0], fh.cdef_uv_strengths[0]),
                frame, frame_blocks, seq.bit_depth, seq.chroma_sampling,
                fh.width, fh.height,
            )

    if rs is not None:
        from encbench.reference.av1.ops.lrf import lrf_filter_frame

        lrf_filter_frame(
            rs, frame, deblocked_planes, fh.width, fh.height,
            seq.bit_depth, seq.chroma_sampling,
        )

    frame.pad()
    return frame


class TileDecoder:
    def __init__(self, seq, fh: FrameHeader, frame: Frame, mi_x0, mi_y0, mi_w, mi_h, mi_cols, mi_rows, ref_frame=None, frame_blocks=None, rs=None, cdef_idx_map=None, init_cdfs=None):
        self.seq = seq
        self.fh = fh
        self.frame = frame
        self.ref_frame = ref_frame
        self.mi_x0, self.mi_y0 = mi_x0, mi_y0
        self.mi_w, self.mi_h = mi_w, mi_h
        self.mi_cols, self.mi_rows = mi_cols, mi_rows
        self.rs = rs
        self.cdef_idx_map = cdef_idx_map
        self._cdef_read = False
        if rs is not None:
            from encbench.reference.av1.ops.lrf import TileRestorationRefs

            self.lrf_refs = TileRestorationRefs()
        self.fc = init_cdfs.copy() if init_cdfs is not None else CDFContext(fh.base_q_idx)
        self.blocks = (
            frame_blocks.subgrid(mi_x0, mi_y0, mi_w, mi_h)
            if frame_blocks is not None
            else FrameBlocks(mi_w, mi_h)
        )
        self.bc = BlockContext(self.blocks)
        self.cr = ContextReader(self.fc, self.bc)
        self.seg_last_active = 0
        self.seg_q = None  # seg_id -> qindex
        if fh.enable_segmentation and fh.segmentation_features:
            deltas = []
            last = 0
            for i in range(8):
                d = fh.segmentation_data[i][0] if fh.segmentation_features[i][0] else 0
                deltas.append(d)
                if any(fh.segmentation_features[i]):
                    last = i
            self.seg_last_active = last
            self.seg_q = [max(1, min(fh.base_q_idx + d, 255)) for d in deltas]
        cs = seq.chroma_sampling
        self.xdec, self.ydec = (0, 0) if cs == ChromaSampling.Cs400 else cs.decimation()
        self.rec_views = []
        self.plane_rect = []
        for pi, p in enumerate(frame.planes):
            xd = 0 if pi == 0 else self.xdec
            yd = 0 if pi == 0 else self.ydec
            px = (mi_x0 << MI_SIZE_LOG2) >> xd
            py = (mi_y0 << MI_SIZE_LOG2) >> yd
            pad = p.cfg.pad
            self.rec_views.append(p.data[pad + py :, pad + px :])
            # coded mi-area extent (mi dims round past the crop, spec 5.9.8)
            rect_w = (mi_w << MI_SIZE_LOG2) >> xd
            rect_h = (mi_h << MI_SIZE_LOG2) >> yd
            self.plane_rect.append((rect_w, rect_h))

    def decode(self, data: bytes) -> None:
        self.r = Reader(data)
        sb_cols = (self.mi_w + MIB_SIZE - 1) // MIB_SIZE
        sb_rows = (self.mi_h + MIB_SIZE - 1) // MIB_SIZE
        from encbench.reference.av1.config import ChromaSampling

        nplanes = 1 if self.seq.chroma_sampling == ChromaSampling.Cs400 else 3
        for sby in range(sb_rows):
            self.bc.reset_left_contexts()
            for sbx in range(sb_cols):
                self._cdef_read = False
                if self.rs is not None:
                    sb_x = (self.mi_x0 // MIB_SIZE) + sbx
                    sb_y = (self.mi_y0 // MIB_SIZE) + sby
                    for pli in range(nplanes):
                        self.cr.read_lrf(self.r, self.rs, self.lrf_refs, sb_x, sb_y, pli)
                self.decode_partition(sbx * MIB_SIZE, sby * MIB_SIZE, BlockSize.BLOCK_64X64)

    def decode_partition(self, x: int, y: int, bsize: BlockSize) -> None:
        if x >= self.mi_w or y >= self.mi_h:
            return
        if bsize >= BlockSize.BLOCK_8X8:
            partition = self.cr.read_partition(self.r, x, y, bsize)
        else:
            partition = PartitionType.PARTITION_NONE
        if partition == PartitionType.PARTITION_SPLIT:
            sub = bsize.subsize(PartitionType.PARTITION_SPLIT)
            sw, sh = sub.width_mi, sub.height_mi
            self.decode_partition(x, y, sub)
            self.decode_partition(x + sw, y, sub)
            self.decode_partition(x, y + sh, sub)
            self.decode_partition(x + sw, y + sh, sub)
        else:
            from encbench.reference.av1.partition import partition_children

            sub = bsize.subsize(partition)
            if sub is None:
                raise DecodeError(f"illegal partition {partition} for {bsize}")
            for (cx, cy, csize) in partition_children(x, y, bsize, partition):
                if cx >= self.mi_w or cy >= self.mi_h:
                    continue
                self.decode_block(cx, cy, csize)
            self.bc.update_partition_context(x, y, sub, bsize)

    def decode_block(self, x: int, y: int, bsize: BlockSize) -> None:
        fh = self.fh
        cs = self.seq.chroma_sampling
        sm = False
        if (
            getattr(fh, "skip_mode_present", False)
            and fh.frame_type.has_inter()
            and bsize.width >= 8
            and bsize.height >= 8
        ):
            sm = self.cr.read_skip_mode(self.r, x, y)
        skip = True if sm else self.cr.read_skip(self.r, x, y)
        self.blocks.set_rect("skip", x, y, bsize, skip)
        if self.seg_q is not None:
            self.cr.read_segmentation(
                self.r, x, y, bsize, skip, self.seg_last_active
            )
        if self.cdef_idx_map is not None and not skip and not self._cdef_read:
            sb_x = (self.mi_x0 + x) // MIB_SIZE
            sb_y = (self.mi_y0 + y) // MIB_SIZE
            self.cdef_idx_map[sb_y, sb_x] = self.r.read_literal(fh.cdef_bits)
            self._cdef_read = True
        self.blocks.set_rect("bsize", x, y, bsize, int(bsize))

        if sm:
            self.blocks.set_rect("is_inter_flag", x, y, bsize, True)
            self._decode_block_skip_mode(x, y, bsize)
            return
        is_inter = False
        if fh.frame_type.has_inter():
            is_inter = self.cr.read_is_inter(self.r, x, y)
        self.blocks.set_rect("is_inter_flag", x, y, bsize, is_inter)
        if is_inter:
            self.decode_block_inter(x, y, bsize, skip)
            return
        self.blocks.set_rect("ref_frames", x, y, bsize, 0)

        if fh.frame_type == FrameType.KEY:
            luma_mode = self.cr.read_intra_mode_kf(self.r, x, y)
        else:
            luma_mode = self.cr.read_intra_mode(self.r, bsize)
        self.blocks.set_rect("mode", x, y, bsize, int(luma_mode))

        angle_delta_y = angle_delta_uv = 0
        if luma_mode.is_directional() and bsize >= BlockSize.BLOCK_8X8:
            angle_delta_y = self.cr.read_angle_delta(self.r, luma_mode)

        do_chroma = has_chroma(x, y, bsize, self.xdec, self.ydec, cs)
        chroma_mode = PredictionMode.DC_PRED
        cfl = (0, 0)
        if do_chroma:
            chroma_mode = self.cr.read_intra_uv_mode(self.r, luma_mode, bsize)
            if chroma_mode.is_cfl():
                cfl = self.cr.read_cfl_alphas(self.r)
            if chroma_mode.is_directional() and bsize >= BlockSize.BLOCK_8X8:
                angle_delta_uv = self.cr.read_angle_delta(self.r, chroma_mode)
            self.blocks.set_rect("uv_mode", x, y, bsize, int(chroma_mode))

        if (
            self.seq.enable_filter_intra
            and luma_mode == PredictionMode.DC_PRED
            and bsize.width <= 32
            and bsize.height <= 32
        ):
            if self.cr.read_use_filter_intra(self.r, bsize):
                raise DecodeError("filter intra unsupported")

        if fh.tx_mode_select and bsize > BlockSize.BLOCK_4X4:
            tx_size = self.cr.read_tx_size_intra(self.r, x, y, bsize)
        else:
            tx_size = MAX_TXSIZE_RECT[int(bsize)]
        self.bc.update_tx_size_context(x, y, bsize, tx_size, False)
        self.blocks.set_rect("tx_size", x, y, bsize, int(tx_size))

        if skip:
            self.bc.reset_skip_context(
                x, y, bsize, self.xdec, self.ydec,
                cs == ChromaSampling.Cs400, do_chroma,
            )

        self._decode_tx_blocks(
            x, y, bsize, luma_mode, chroma_mode, tx_size, angle_delta_y,
            angle_delta_uv, skip, do_chroma, cfl,
        )

    def decode_block_inter(self, x: int, y: int, bsize: BlockSize, skip: bool) -> None:
        from encbench.reference.av1.context.mv import (
            REF_CAT_LEVEL,
            MvFinder,
            fill_neighbours_ref_counts,
        )
        from encbench.reference.av1.context.writer import MAX_TXSIZE_RECT

        fh = self.fh
        counts = fill_neighbours_ref_counts(self.blocks, x, y)
        finder = MvFinder(self.blocks, self.mi_cols, self.mi_rows, self.mi_x0, self.mi_y0)
        if fh.reference_mode_select and self.cr.read_comp_mode(self.r, x, y):
            self._decode_block_inter_compound(x, y, bsize, skip, counts, finder)
            return
        ref_frame = self.cr.read_ref_frames_single(self.r, counts)
        stack, mode_ctx = finder.find_mvrefs(x, y, ref_frame, bsize, lambda r: 0)
        mode = self.cr.read_inter_mode(self.r, mode_ctx)
        num_found = len(stack)
        ref_mv_idx = 0
        if mode == PredictionMode.NEWMV:
            for idx in range(2):
                if num_found > idx + 1:
                    ctx = int(stack[idx].weight < REF_CAT_LEVEL) + int(
                        stack[idx + 1].weight < REF_CAT_LEVEL
                    )
                    if self.cr.read_drl_mode(self.r, ctx):
                        ref_mv_idx = idx + 1
                        continue
                    break
            ref_mv = tuple(stack[ref_mv_idx].this_mv) if num_found > 0 else (0, 0)
            mv = self.cr.read_mv(self.r, ref_mv, precision=1)
        elif mode == PredictionMode.NEARESTMV:
            mv = tuple(stack[0].this_mv) if stack else (0, 0)
        elif mode == PredictionMode.GLOBALMV:
            mv = (0, 0)
        else:  # NEARMV (ref_mv_idx from DRL; spec 5.11.25)
            ref_mv_idx = 1
            for idx in (1, 2):
                if num_found > idx + 1:
                    ctx = int(stack[idx].weight < REF_CAT_LEVEL) + int(
                        stack[idx + 1].weight < REF_CAT_LEVEL
                    )
                    if self.cr.read_drl_mode(self.r, ctx):
                        ref_mv_idx = idx + 1
                        continue
                    break
            mv = tuple(stack[ref_mv_idx].this_mv) if len(stack) > ref_mv_idx else (0, 0)

        self.blocks.set_rect("mode", x, y, bsize, int(mode))
        self.blocks.ref_frames[y : y + bsize.height_mi, x : x + bsize.width_mi, 0] = ref_frame
        self.blocks.ref_frames[y : y + bsize.height_mi, x : x + bsize.width_mi, 1] = -1
        self.blocks.mv[y : y + bsize.height_mi, x : x + bsize.width_mi, 0, 0] = mv[0]
        self.blocks.mv[y : y + bsize.height_mi, x : x + bsize.width_mi, 0, 1] = mv[1]

        tx_size = MAX_TXSIZE_RECT[int(bsize)]
        if fh.tx_mode_select:
            if bsize > BlockSize.BLOCK_4X4 and not skip:
                tx_size = self.cr.read_tx_size_inter(self.r, x, y, bsize, tx_size, 0, 0, 0)
            else:
                self.bc.update_tx_size_context(x, y, bsize, tx_size, skip)
        else:
            self.bc.update_tx_size_context(x, y, bsize, tx_size, skip)
        self.blocks.set_rect("tx_size", x, y, bsize, int(tx_size))

        if skip:
            self.bc.reset_skip_context(
                x, y, bsize, self.xdec, self.ydec,
                self.seq.chroma_sampling == ChromaSampling.Cs400,
                has_chroma(x, y, bsize, self.xdec, self.ydec, self.seq.chroma_sampling),
            )

        ref_obj = self.ref_frame[ref_frame - 1]
        if ref_obj is None:
            from encbench.reference.av1.decoder.headers import DecodeError

            raise DecodeError(f"missing reference frame {ref_frame}")
        self._motion_compensate(x, y, bsize, mv, ref_obj)
        do_chroma = has_chroma(x, y, bsize, self.xdec, self.ydec, self.seq.chroma_sampling)
        if not skip:
            self._decode_inter_residual(x, y, bsize, mode, tx_size, do_chroma)

    def _decode_block_skip_mode(self, x, y, bsize) -> None:
        """Skip-mode block (spec 7.8/5.11.27): compound NEAREST_NEARESTMV on
        the frame's derived (LAST, ALTREF) pair, skip=1, no residual."""
        from encbench.reference.av1.context.mv import ALTREF_FRAME, LAST_FRAME, MvFinder
        from encbench.reference.av1.context.writer import MAX_TXSIZE_RECT

        fh = self.fh
        finder = MvFinder(
            self.blocks, self.mi_cols, self.mi_rows, self.mi_x0, self.mi_y0
        )
        stack, _ = finder.find_mvrefs(
            x, y, (LAST_FRAME, ALTREF_FRAME), bsize, lambda r: 0
        )
        mv0 = tuple(stack[0].this_mv) if stack else (0, 0)
        mv1 = tuple(stack[0].comp_mv) if stack else (0, 0)
        mode = PredictionMode.NEAREST_NEARESTMV
        self.blocks.set_rect("mode", x, y, bsize, int(mode))
        self.blocks.ref_frames[y : y + bsize.height_mi, x : x + bsize.width_mi, 0] = LAST_FRAME
        self.blocks.ref_frames[y : y + bsize.height_mi, x : x + bsize.width_mi, 1] = ALTREF_FRAME
        self.blocks.mv[y : y + bsize.height_mi, x : x + bsize.width_mi, 0, 0] = mv0[0]
        self.blocks.mv[y : y + bsize.height_mi, x : x + bsize.width_mi, 0, 1] = mv0[1]
        self.blocks.mv[y : y + bsize.height_mi, x : x + bsize.width_mi, 1, 0] = mv1[0]
        self.blocks.mv[y : y + bsize.height_mi, x : x + bsize.width_mi, 1, 1] = mv1[1]

        tx_size = MAX_TXSIZE_RECT[int(bsize)]
        if fh.tx_mode_select:
            self.bc.update_tx_size_context(x, y, bsize, tx_size, True)
        else:
            self.bc.update_tx_size_context(x, y, bsize, tx_size, True)
        self.blocks.set_rect("tx_size", x, y, bsize, int(tx_size))
        self.bc.reset_skip_context(
            x, y, bsize, self.xdec, self.ydec,
            self.seq.chroma_sampling == ChromaSampling.Cs400,
            has_chroma(x, y, bsize, self.xdec, self.ydec, self.seq.chroma_sampling),
        )
        ref_obj0 = self.ref_frame[LAST_FRAME - 1]
        ref_obj1 = self.ref_frame[ALTREF_FRAME - 1]
        if ref_obj0 is None or ref_obj1 is None:
            raise DecodeError("missing skip-mode reference frame")
        self._motion_compensate_compound(x, y, bsize, mv0, mv1, ref_obj0, ref_obj1)

    def _decode_block_inter_compound(self, x, y, bsize, skip, counts, finder) -> None:
        """Compound bidirectional block (mirror of
        _encode_block_inter_compound)."""
        from encbench.reference.av1.context.mv import REF_CAT_LEVEL
        from encbench.reference.av1.context.writer import MAX_TXSIZE_RECT

        fh = self.fh
        rf0, rf1 = self.cr.read_ref_frames_compound(self.r, x, y, counts)
        stack, mode_ctx = finder.find_mvrefs(x, y, (rf0, rf1), bsize, lambda r: 0)
        mode = self.cr.read_compound_mode(self.r, mode_ctx)
        num_found = len(stack)
        if mode == PredictionMode.NEW_NEWMV:
            ref_mv_idx = 0
            for idx in range(2):
                if num_found > idx + 1:
                    ctx = int(stack[idx].weight < REF_CAT_LEVEL) + int(
                        stack[idx + 1].weight < REF_CAT_LEVEL
                    )
                    if self.cr.read_drl_mode(self.r, ctx):
                        ref_mv_idx = idx + 1
                        continue
                    break
            ref0 = tuple(stack[ref_mv_idx].this_mv) if num_found > 0 else (0, 0)
            ref1 = tuple(stack[ref_mv_idx].comp_mv) if num_found > 0 else (0, 0)
            mv0 = self.cr.read_mv(self.r, ref0, precision=1)
            mv1 = self.cr.read_mv(self.r, ref1, precision=1)
        elif mode == PredictionMode.NEAREST_NEARESTMV:
            mv0 = tuple(stack[0].this_mv) if stack else (0, 0)
            mv1 = tuple(stack[0].comp_mv) if stack else (0, 0)
        elif mode == PredictionMode.NEAREST_NEWMV:
            # no DRL (spec 5.11.24); one MVD for the second side
            mv0 = tuple(stack[0].this_mv) if stack else (0, 0)
            ref1 = tuple(stack[0].comp_mv) if stack else (0, 0)
            mv1 = self.cr.read_mv(self.r, ref1, precision=1)
        elif mode == PredictionMode.NEW_NEARESTMV:
            mv1 = tuple(stack[0].comp_mv) if stack else (0, 0)
            ref0 = tuple(stack[0].this_mv) if stack else (0, 0)
            mv0 = self.cr.read_mv(self.r, ref0, precision=1)
        elif mode == PredictionMode.NEAR_NEAR0MV:
            ref_mv_idx = 1
            for idx in (1, 2):
                if num_found > idx + 1:
                    ctx = int(stack[idx].weight < REF_CAT_LEVEL) + int(
                        stack[idx + 1].weight < REF_CAT_LEVEL
                    )
                    if self.cr.read_drl_mode(self.r, ctx):
                        ref_mv_idx = idx + 1
                        continue
                    ref_mv_idx = idx
                    break
            k = min(ref_mv_idx, num_found - 1) if num_found else 0
            mv0 = tuple(stack[k].this_mv) if stack else (0, 0)
            mv1 = tuple(stack[k].comp_mv) if stack else (0, 0)
        else:  # GLOBAL_GLOBALMV
            mv0 = (0, 0)
            mv1 = (0, 0)

        self.blocks.set_rect("mode", x, y, bsize, int(mode))
        self.blocks.ref_frames[y : y + bsize.height_mi, x : x + bsize.width_mi, 0] = rf0
        self.blocks.ref_frames[y : y + bsize.height_mi, x : x + bsize.width_mi, 1] = rf1
        self.blocks.mv[y : y + bsize.height_mi, x : x + bsize.width_mi, 0, 0] = mv0[0]
        self.blocks.mv[y : y + bsize.height_mi, x : x + bsize.width_mi, 0, 1] = mv0[1]
        self.blocks.mv[y : y + bsize.height_mi, x : x + bsize.width_mi, 1, 0] = mv1[0]
        self.blocks.mv[y : y + bsize.height_mi, x : x + bsize.width_mi, 1, 1] = mv1[1]

        tx_size = MAX_TXSIZE_RECT[int(bsize)]
        if fh.tx_mode_select:
            if bsize > BlockSize.BLOCK_4X4 and not skip:
                tx_size = self.cr.read_tx_size_inter(self.r, x, y, bsize, tx_size, 0, 0, 0)
            else:
                self.bc.update_tx_size_context(x, y, bsize, tx_size, skip)
        else:
            self.bc.update_tx_size_context(x, y, bsize, tx_size, skip)
        self.blocks.set_rect("tx_size", x, y, bsize, int(tx_size))

        if skip:
            self.bc.reset_skip_context(
                x, y, bsize, self.xdec, self.ydec,
                self.seq.chroma_sampling == ChromaSampling.Cs400,
                has_chroma(x, y, bsize, self.xdec, self.ydec, self.seq.chroma_sampling),
            )

        ref_obj0 = self.ref_frame[rf0 - 1]
        ref_obj1 = self.ref_frame[rf1 - 1]
        if ref_obj0 is None or ref_obj1 is None:
            raise DecodeError("missing compound reference frame")
        self._motion_compensate_compound(x, y, bsize, mv0, mv1, ref_obj0, ref_obj1)
        do_chroma = has_chroma(x, y, bsize, self.xdec, self.ydec, self.seq.chroma_sampling)
        if not skip:
            self._decode_inter_residual(x, y, bsize, mode, tx_size, do_chroma)

    def _motion_compensate_compound(self, x, y, bsize, mv0, mv1, ref0, ref1) -> None:
        from encbench.reference.av1.ops.mc import mc_avg, mv_to_offsets, prep_8tap

        do_chroma = has_chroma(x, y, bsize, self.xdec, self.ydec, self.seq.chroma_sampling)
        nplanes = 3 if (do_chroma and self.seq.chroma_sampling != ChromaSampling.Cs400) else 1
        for p in range(nplanes):
            xd = 0 if p == 0 else self.xdec
            yd = 0 if p == 0 else self.ydec
            w_px = max(bsize.width >> xd, 4)
            h_px = max(bsize.height >> yd, 4)
            px = ((self.mi_x0 + x) << MI_SIZE_LOG2) >> xd
            py = ((self.mi_y0 + y) << MI_SIZE_LOG2) >> yd
            tmps = []
            for ref_obj, mv in ((ref0, mv0), (ref1, mv1)):
                plane = ref_obj.planes[p]
                pad = plane.cfg.pad
                ri, ci, rf, cf = mv_to_offsets(mv[0], mv[1], xd, yd)
                tmps.append(prep_8tap(
                    plane.data, pad + px + ci, pad + py + ri, w_px, h_px,
                    cf, rf, 0, 0, self.seq.bit_depth,
                ))
            pred = mc_avg(tmps[0], tmps[1], self.seq.bit_depth)
            rel_x = (x << MI_SIZE_LOG2) >> xd
            rel_y = (y << MI_SIZE_LOG2) >> yd
            self.rec_views[p][rel_y : rel_y + h_px, rel_x : rel_x + w_px] = pred

    def _motion_compensate(self, x: int, y: int, bsize: BlockSize, mv, ref_obj) -> None:
        from encbench.reference.av1.ops.mc import REGULAR, mv_to_offsets, put_8tap

        do_chroma = has_chroma(x, y, bsize, self.xdec, self.ydec, self.seq.chroma_sampling)
        nplanes = 3 if (do_chroma and self.seq.chroma_sampling != ChromaSampling.Cs400) else 1
        for p in range(nplanes):
            xd = 0 if p == 0 else self.xdec
            yd = 0 if p == 0 else self.ydec
            ref_plane = ref_obj.planes[p]
            pad = ref_plane.cfg.pad
            w_px = max(bsize.width >> xd, 4)
            h_px = max(bsize.height >> yd, 4)
            px = ((self.mi_x0 + x) << MI_SIZE_LOG2) >> xd
            py = ((self.mi_y0 + y) << MI_SIZE_LOG2) >> yd
            row_int, col_int, row_frac, col_frac = mv_to_offsets(mv[0], mv[1], xd, yd)
            pred = put_8tap(
                ref_plane.data, pad + px + col_int, pad + py + row_int,
                w_px, h_px, col_frac, row_frac, REGULAR, REGULAR, self.seq.bit_depth,
            )
            rel_x = (x << MI_SIZE_LOG2) >> xd
            rel_y = (y << MI_SIZE_LOG2) >> yd
            self.rec_views[p][rel_y : rel_y + h_px, rel_x : rel_x + w_px] = pred

    def _decode_inter_residual(self, x, y, bsize: BlockSize, mode, tx_size: TxSize, do_chroma) -> None:
        fh = self.fh
        bw = max(bsize.width_mi // max(tx_size.width >> MI_SIZE_LOG2, 1), 1)
        bh = max(bsize.height_mi // max(tx_size.height >> MI_SIZE_LOG2, 1), 1)
        for by in range(bh):
            for bx in range(bw):
                tx_x = x + bx * (tx_size.width >> MI_SIZE_LOG2)
                tx_y = y + by * (tx_size.height >> MI_SIZE_LOG2)
                if tx_x >= self.mi_w or tx_y >= self.mi_h:
                    continue
                self._decode_inter_tx_block(0, x, y, bx, by, tx_x, tx_y, mode, tx_size, bsize)
        if not do_chroma or self.seq.chroma_sampling == ChromaSampling.Cs400:
            return
        uv_tx_size = largest_chroma_tx_size(bsize, self.xdec, self.ydec)
        bw_uv = max((bw * (tx_size.width >> MI_SIZE_LOG2)) >> self.xdec, 1) // max(
            uv_tx_size.width >> MI_SIZE_LOG2, 1
        )
        bh_uv = max((bh * (tx_size.height >> MI_SIZE_LOG2)) >> self.ydec, 1) // max(
            uv_tx_size.height >> MI_SIZE_LOG2, 1
        )
        for p in (1, 2):
            for by in range(max(bh_uv, 1)):
                for bx in range(max(bw_uv, 1)):
                    tx_x = x + ((bx * (uv_tx_size.width >> MI_SIZE_LOG2)) << self.xdec)
                    tx_y = y + ((by * (uv_tx_size.height >> MI_SIZE_LOG2)) << self.ydec)
                    self._decode_inter_tx_block(p, x, y, bx, by, tx_x, tx_y, mode, uv_tx_size, bsize)

    def _decode_inter_tx_block(self, p, part_x, part_y, bx, by, tx_x, tx_y, mode, tx_size, bsize) -> None:
        fh = self.fh
        xd = 0 if p == 0 else self.xdec
        yd = 0 if p == 0 else self.ydec
        if tx_x >= self.mi_w or tx_y >= self.mi_h:
            return
        w_px, h_px = tx_size.width, tx_size.height
        if p == 0:
            px = tx_x << MI_SIZE_LOG2
            py = tx_y << MI_SIZE_LOG2
        else:
            px = ((part_x << MI_SIZE_LOG2) >> xd) + bx * w_px
            py = ((part_y << MI_SIZE_LOG2) >> yd) + by * h_px
        rec = self.rec_views[p]
        plane_bsize = bsize.chroma_block_size(xd, yd) if p else bsize
        frame_clipped_txw = min(((self.mi_cols - (self.mi_x0 + tx_x)) << MI_SIZE_LOG2) >> xd, w_px)
        frame_clipped_txh = min(((self.mi_rows - (self.mi_y0 + tx_y)) << MI_SIZE_LOG2) >> yd, h_px)
        qcoeffs, eob, tx_type = self.cr.read_coeffs_lv_map(
            self.r, p, tx_x, tx_y, mode, tx_size, TxType.DCT_DCT, plane_bsize,
            xd, yd, fh.use_reduced_tx_set, frame_clipped_txw, frame_clipped_txh,
        )
        if eob > 0:
            from encbench.reference.av1.native import dequant_recon_native

            if not dequant_recon_native(
                qcoeffs, self._block_qidx(part_x, part_y), tx_size, tx_type, self.seq.bit_depth,
                rec, px, py, fh.dc_delta_q[p], fh.ac_delta_q[p],
            ):
                pred = rec[py : py + h_px, px : px + w_px].astype(np.int32)
                rcoeffs = dequantize(
                    self._block_qidx(part_x, part_y), qcoeffs, tx_size, self.seq.bit_depth,
                    fh.dc_delta_q[p], fh.ac_delta_q[p],
                )
                recon = T.inverse_transform_add(
                    rcoeffs[None], pred[None], tx_size, tx_type, self.seq.bit_depth
                )[0]
                rec[py : py + h_px, px : px + w_px] = recon

    def _decode_tx_blocks(
        self, x, y, bsize, luma_mode, chroma_mode, tx_size, angle_delta_y,
        angle_delta_uv, skip, do_chroma, cfl,
    ):
        bw = max(bsize.width_mi // max(tx_size.width >> MI_SIZE_LOG2, 1), 1)
        bh = max(bsize.height_mi // max(tx_size.height >> MI_SIZE_LOG2, 1), 1)
        for by in range(bh):
            for bx in range(bw):
                tx_x = x + bx * (tx_size.width >> MI_SIZE_LOG2)
                tx_y = y + by * (tx_size.height >> MI_SIZE_LOG2)
                if tx_x >= self.mi_w or tx_y >= self.mi_h:
                    continue
                self._decode_tx_block(
                    0, x, y, bx, by, tx_x, tx_y, luma_mode, tx_size,
                    None, bsize, skip, angle_delta_y,
                )
        if not do_chroma or self.seq.chroma_sampling == ChromaSampling.Cs400:
            return
        uv_tx_size = largest_chroma_tx_size(bsize, self.xdec, self.ydec)
        if uv_tx_size.width >= 32 or uv_tx_size.height >= 32:
            uv_tx_type = TxType.DCT_DCT
        else:
            uv_tx_type = uv_intra_mode_to_tx_type_context(chroma_mode)
        bw_uv = max((bw * (tx_size.width >> MI_SIZE_LOG2)) >> self.xdec, 1) // max(
            uv_tx_size.width >> MI_SIZE_LOG2, 1
        )
        bh_uv = max((bh * (tx_size.height >> MI_SIZE_LOG2)) >> self.ydec, 1) // max(
            uv_tx_size.height >> MI_SIZE_LOG2, 1
        )
        bw_uv = max(bw_uv, 1)
        bh_uv = max(bh_uv, 1)
        ac = None
        if chroma_mode.is_cfl():
            from encbench.reference.av1.ops.intra import luma_ac

            fcw = min(((self.mi_cols - (self.mi_x0 + x)) << MI_SIZE_LOG2), bsize.width)
            fch = min(((self.mi_rows - (self.mi_y0 + y)) << MI_SIZE_LOG2), bsize.height)
            ac = luma_ac(
                self.rec_views[0], x << MI_SIZE_LOG2, y << MI_SIZE_LOG2, bsize,
                self.xdec, self.ydec, tx_size, fcw, fch,
            )
        for p in (1, 2):
            alpha = cfl[p - 1] if chroma_mode.is_cfl() else 0
            for by in range(bh_uv):
                for bx in range(bw_uv):
                    tx_x = x + ((bx * (uv_tx_size.width >> MI_SIZE_LOG2)) << self.xdec) - (
                        int(bw * (tx_size.width >> MI_SIZE_LOG2) == 1) * self.xdec
                    )
                    tx_y = y + ((by * (uv_tx_size.height >> MI_SIZE_LOG2)) << self.ydec) - (
                        int(bh * (tx_size.height >> MI_SIZE_LOG2) == 1) * self.ydec
                    )
                    ac_slice = None
                    if ac is not None:
                        ac_slice = ac[
                            by * uv_tx_size.height : (by + 1) * uv_tx_size.height,
                            bx * uv_tx_size.width : (bx + 1) * uv_tx_size.width,
                        ]
                    self._decode_tx_block(
                        p, x, y, bx, by, tx_x, tx_y, chroma_mode, uv_tx_size,
                        uv_tx_type, bsize, skip, angle_delta_uv,
                        alpha=alpha, ac=ac_slice,
                    )

    def _block_qidx(self, x: int, y: int) -> int:
        if self.seg_q is None:
            return self.fh.base_q_idx
        sid = int(self.blocks.segmentation_idx[y, x])
        return self.seg_q[sid]

    def _decode_tx_block(
        self, p, part_x, part_y, bx, by, tx_x, tx_y, mode, tx_size,
        uv_tx_type, bsize, skip, angle_delta, alpha=0, ac=None,
    ):
        fh = self.fh
        xd = 0 if p == 0 else self.xdec
        yd = 0 if p == 0 else self.ydec
        if tx_x >= self.mi_w or tx_y >= self.mi_h:
            return
        w_px, h_px = tx_size.width, tx_size.height
        if p == 0:
            px = tx_x << MI_SIZE_LOG2
            py = tx_y << MI_SIZE_LOG2
        else:
            px = ((part_x << MI_SIZE_LOG2) >> xd) + bx * w_px
            py = ((part_y << MI_SIZE_LOG2) >> yd) + by * h_px
        rec = self.rec_views[p]
        rect_w, rect_h = self.plane_rect[p]
        plane_bsize = bsize.chroma_block_size(xd, yd) if p else bsize

        edge = build_intra_edge(
            rec, rect_w, rect_h, px, py, tx_size, part_x, part_y, bx, by,
            bsize, xd, yd, self.seq.bit_depth, mode, angle_delta,
        )
        ief = None
        if mode.is_directional() and self.seq.enable_intra_edge_filter:
            from encbench.reference.av1.encoder.pipeline import build_ief_params

            ief = build_ief_params(self.blocks, part_x, part_y, p, xd, yd)
        pred = predict_intra(
            mode, edge, w_px, h_px, self.seq.bit_depth, angle_delta,
            alpha=alpha, ac=ac, ief_params=ief,
        )
        rec[py : py + h_px, px : px + w_px] = pred
        if skip:
            return

        frame_clipped_txw = min(((self.mi_cols - (self.mi_x0 + tx_x)) << MI_SIZE_LOG2) >> xd, w_px)
        frame_clipped_txh = min(((self.mi_rows - (self.mi_y0 + tx_y)) << MI_SIZE_LOG2) >> yd, h_px)

        qcoeffs, eob, tx_type = self.cr.read_coeffs_lv_map(
            self.r, p, tx_x, tx_y, mode, tx_size, uv_tx_type, plane_bsize,
            xd, yd, fh.use_reduced_tx_set, frame_clipped_txw, frame_clipped_txh,
        )
        if eob > 0:
            from encbench.reference.av1.native import dequant_recon_native

            if not dequant_recon_native(
                qcoeffs, self._block_qidx(part_x, part_y), tx_size, tx_type, self.seq.bit_depth,
                rec, px, py, fh.dc_delta_q[p], fh.ac_delta_q[p],
            ):
                rcoeffs = dequantize(
                    self._block_qidx(part_x, part_y), qcoeffs, tx_size, self.seq.bit_depth,
                    fh.dc_delta_q[p], fh.ac_delta_q[p],
                )
                recon = T.inverse_transform_add(
                    rcoeffs[None], pred[None], tx_size, tx_type, self.seq.bit_depth
                )[0]
                rec[py : py + h_px, px : px + w_px] = recon
