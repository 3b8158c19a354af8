"""Frame pipeline of the PyTorch port.

:class:`FramePipeline` is ``rav1e_tpu.encoder.pipeline.FramePipeline`` with
its device stage on PyTorch: the whole-frame analysis of
``rav1e_tpu_torch.device.analysis`` and the CDEF stage of
``rav1e_tpu_torch.device.filters``, on the device the config names.  The
host tile coders, the symbol layer and the bitstream writer are the
reference's own.  Device errors propagate: nothing falls back to the host
search.

The device-chain tier (``speed_settings.device_chain``) is not ported yet;
``rav1e_tpu_torch.Config.validate`` rejects it and :class:`FramePipeline`
refuses it.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from rav1e_tpu import tables
from rav1e_tpu.api.util import EncoderStats, FrameType, Packet
from rav1e_tpu.config import InvalidConfig
from rav1e_tpu.context import FrameBlocks
from rav1e_tpu.encoder import pipeline as _ref
from rav1e_tpu.encoder.obu import (
    FrameHeaderInfo,
    ObuType,
    frame_header_payload,
    sequence_header_obu,
    temporal_delimiter,
    wrap_obu,
)
from rav1e_tpu.encoder.pipeline import MIB_SIZE, FrameInvariantsLite
from rav1e_tpu.frame import Frame
from rav1e_tpu_torch.device import (
    analyze_finish,
    analyze_frame_async,
    cdef_device_frame,
    upload_source_luma,
)


class FramePipeline(_ref.FramePipeline):
    """Owns sequence state and encodes frames to packets, with the device
    analysis and device CDEF on ``config.device``."""

    def __init__(self, config):
        if config.enc.speed_settings.device_chain:
            raise InvalidConfig(
                "speed_settings.device_chain=True: the device-chain tier "
                "(device/chain.py) is not ported to rav1e_tpu_torch yet"
            )
        super().__init__(config)
        self.device = torch.device(config.device)

    # ------------------------------------------------------------------
    # device entry points (rav1e_tpu/encoder/pipeline.py:2282-2426)
    # ------------------------------------------------------------------

    def _dev_luma(self, fno, luma_np):
        """Device tensor for a source luma plane, put on the device at most
        once per input_frameno (see _dev_luma_cache).  Planes with no
        frame number pass through as numpy."""
        if luma_np is None or fno is None:
            return luma_np
        dev = self._dev_luma_cache.get(fno)
        if dev is None:
            dev = upload_source_luma(luma_np, self.device)
            self._dev_luma_cache[fno] = dev
            while len(self._dev_luma_cache) > 12:
                self._dev_luma_cache.pop(next(iter(self._dev_luma_cache)))
        return dev

    def predispatch_idle(self, next_hints) -> None:
        """Predispatch from a non-coding point (e.g. while emitting a
        show-existing packet): reference slots are already final."""
        enc = self.config.enc
        if not next_hints:
            return
        if not (enc.speed_settings.device_analysis
                and min(enc.width, enc.height) >= 64):
            return
        self._predispatch_analyses(next_hints, None, None, None)

    def _predispatch_analyses(self, next_hints, cur_frame, cur_ft, cur_plan):
        """Launch upcoming planned frames' device analyses.

        Runs right after this frame's maps are fetched, so the next frames'
        device work overlaps this frame's host tile coding and loop filters
        (PyTorch launches on a CUDA device are asynchronous; the pending
        entry holds the result tensors until encode_frame copies them to
        the host).  Reference-slot contents for frames deeper than one step
        are simulated by walking the plan's refresh sequence over the
        queued source frames; each entry records the source framenos it
        saw, and consumption re-validates them against the slots' actual
        content and the qi, so a divergent simulation degrades to the sync
        path instead of a wrong bitstream.  Uses the RC's current qi
        estimate (stale by up to `depth` frames): the analysis q only steers
        heuristics, and the estimate is deterministic, so bitstreams stay
        reproducible."""
        enc = self.config.enc
        # slot -> (source input_frameno, source luma); seeded from the live
        # buffers, then overlaid by the current frame's refresh and every
        # simulated planned refresh in turn
        sim: dict = {}
        if cur_frame is not None:
            cur_refresh = (
                0xFF
                if cur_ft in (FrameType.KEY, FrameType.SWITCH)
                else (1 << cur_plan.slot)
            )
            cur_src = cur_frame.planes[0].as_array()[: enc.height, : enc.width]
            for i in range(8):
                if (cur_refresh >> i) & 1:
                    sim[i] = (cur_plan.input_frameno, cur_src)

        def slot_state(slot):
            if slot in sim:
                return sim[slot]
            return (self.slot_src_frameno[slot], self._ref_src_luma(slot))

        for nplan, nframe in next_hints:
            if len(self._pending_analyses) >= len(next_hints):
                break
            fno = nplan.input_frameno
            n_src = nframe.planes[0].as_array()[: enc.height, : enc.width]
            if fno not in self._pending_analyses:
                is_key = nplan.kind == "key"
                ref_y = ref_y_bwd = ref_y_bwd2 = None
                ref_fno_fwd = ref_fno_bwd = ref_fno_bwd2 = None
                is_inter = False
                if not is_key:
                    ref_fno_fwd, ref_y = slot_state(nplan.ref_slot_fwd)
                    is_inter = ref_y is not None and ref_fno_fwd is not None
                    if is_inter and nplan.ref_slot_bwd is not None:
                        ref_fno_bwd, ref_y_bwd = slot_state(nplan.ref_slot_bwd)
                        if ref_y_bwd is None:
                            ref_fno_bwd = None
                    if (
                        is_inter
                        and ref_y_bwd is not None
                        and getattr(nplan, "ref_slot_bwd2", None) is not None
                        and enc.speed_settings.multiref
                    ):
                        ref_fno_bwd2, ref_y_bwd2 = slot_state(
                            nplan.ref_slot_bwd2
                        )
                        if ref_y_bwd2 is None:
                            ref_fno_bwd2 = None
                    if not is_inter:
                        ref_y = ref_y_bwd = ref_y_bwd2 = None
                        ref_fno_fwd = ref_fno_bwd = ref_fno_bwd2 = None
                q_guess = self.rc.select_qi(
                    FrameType.KEY if is_key else FrameType.INTER,
                    enc.width, enc.height, nplan.level,
                )
                q_step = tables.ac_q(q_guess, 0, enc.bit_depth) / 8.0
                lam = 0.12 * q_step * q_step
                handle = analyze_frame_async(
                    self._dev_luma(fno, n_src),
                    self._dev_luma(ref_fno_fwd, ref_y),
                    self._dev_luma(ref_fno_bwd, ref_y_bwd),
                    q_guess, lam, enc.bit_depth,
                    ref2_np=self._dev_luma(ref_fno_bwd2, ref_y_bwd2),
                    device=self.device,
                )
                self._pending_analyses[fno] = {
                    "q": q_guess,
                    "is_inter": is_inter,
                    "ref_fno_fwd": ref_fno_fwd,
                    "ref_fno_bwd": ref_fno_bwd,
                    "ref_fno_bwd2": ref_fno_bwd2,
                    "handle": handle,
                }
            # simulate this planned frame's slot refresh for deeper hints
            refresh = (
                0xFF if (nplan.kind == "key" or nplan.switch)
                else (1 << nplan.slot)
            )
            for i in range(8):
                if (refresh >> i) & 1:
                    sim[i] = (fno, n_src)

    # ------------------------------------------------------------------
    # The two long bodies below are copies of rav1e_tpu/encoder/pipeline.py
    # with only the device calls swapped; their control flow is kept
    # identical, because byte identity with the reference depends on it.
    # ------------------------------------------------------------------

    def _encode_frame_host(self, fi, frame, frame_type, mi_cols, mi_rows,
                           input_frameno):
        """Host-tier encode body: tile coding + in-loop filters + the
        two-pass CDEF/LRF replay (the pre-chain path, all presets).

        Copy of rav1e_tpu/encoder/pipeline.py:2906-3162 with the device CDEF
        stage on this pipeline's device."""
        enc = self.config.enc
        use_device = (
            enc.speed_settings.device_analysis
            and min(enc.width, enc.height) >= 64
        )
        # select the full-pel search family for this frame's speed tier
        # (native ME reads it as a per-process constant; the python fallback
        # reads speed.motion directly)
        from rav1e_tpu import native as _native

        _lib = _native.get_lib()
        if _lib is not None:
            _lib.enc_me_set_method(
                enc.speed_settings.motion.me_method,
                enc.speed_settings.motion.me_range,
            )

        rec = Frame.new(enc.width, enc.height, enc.chroma_sampling, enc.bit_depth)
        frame_blocks = FrameBlocks(mi_cols, mi_rows)

        # encode tiles (structure ready for parallel/sharded execution)
        from rav1e_tpu.utils.trace import span

        tile_payloads: List[bytes] = []
        enc_stats = EncoderStats()
        with span("encode_tiles", frame=input_frameno):
            (tile_payloads, enc_stats, frame_cdfs, decisions,
             coeff_logs) = self._encode_tiles(
                fi, frame, rec, frame_blocks, mi_cols, mi_rows, record=True
            )

        tile_group = self._build_tile_group(tile_payloads)

        # in-loop filters on the reconstruction (frame-level, across tiles).
        # Levels via the q-derived fast rule; SSE-tally search comes with RDO.
        from rav1e_tpu.ops.deblock import deblock_filter_frame, deblock_levels_fast

        deblock_levels = deblock_levels_fast(
            fi.base_q_idx, fi.bit_depth, frame_type == FrameType.KEY,
            tables.ac_q(fi.base_q_idx, 0, fi.bit_depth),
        )
        if not enc.speed_settings.fast_deblock:
            from rav1e_tpu.ops.deblock import deblock_search_levels

            with span("deblock_search"):
                deblock_levels = deblock_search_levels(
                    deblock_levels, rec, frame, frame_blocks,
                    enc.width, enc.height, fi.bit_depth, enc.chroma_sampling,
                )
        with span("deblock"):
            deblock_filter_frame(
                deblock_levels, rec, frame_blocks, enc.width, enc.height,
                fi.bit_depth, enc.chroma_sampling,
            )

        sb_w = (mi_cols + MIB_SIZE - 1) // MIB_SIZE
        sb_h = (mi_rows + MIB_SIZE - 1) // MIB_SIZE

        # keep the pre-CDEF (deblocked) planes for loop restoration
        # (lrf.rs:1485: LRF reads deblocked rows at stripe boundaries)
        # LRUs are frame-global geometry; tiles only partition which SB
        # codes each unit's symbols, and the ref predictors reset per tile
        # (TileRestorationRefs in both tile coder and decoder) — so LRF
        # works under multi-tile (tile_restoration_state.rs:49 semantics)
        use_lrf = self.seq.enable_restoration
        deblocked_planes = None
        if use_lrf:
            deblocked_planes = [
                p.data[p.cfg.pad :, p.cfg.pad :].copy() for p in rec.planes
            ]

        # CDEF (after deblock, before LRF; cdef.rs:574-600): q-derived
        # single strength at fast speeds, per-64x64 RDO over a 4-entry
        # preset (cdef_bits=2) at quality speeds (rdo.rs:2104 CDEF axis).
        cdef_damping, cdef_y, cdef_uv = 3, 0, 0
        cdef_bits = 0
        cdef_map = None
        cdef_y_list = None
        cdef_uv_list = None
        if self.seq.enable_cdef:
            from rav1e_tpu.ops.cdef import (
                cdef_filter_frame, cdef_rdo_frame, cdef_strengths_fast,
            )

            cdef_y, cdef_uv = cdef_strengths_fast(
                tables.ac_q(fi.base_q_idx, 0, fi.bit_depth) >> (fi.bit_depth - 8)
            )
            if not enc.speed_settings.fast_deblock and cdef_y > 0 and use_device:
                # device filter stage: strength RDO sweep + per-SB argmin +
                # apply on the device (device/filters.py); bit-equal to the
                # host path (tests/test_torch_filters.py)
                with span("cdef_rdo_device"):
                    cdef_y_list, cdef_uv_list, cdef_map, _applied = (
                        cdef_device_frame(
                            rec, frame, frame_blocks, fi.bit_depth,
                            enc.chroma_sampling, enc.width, enc.height,
                            cdef_damping, cdef_y, cdef_uv,
                            device=self.device,
                        )
                    )
                cdef_state = None
                cdef_bits = 2
            elif not enc.speed_settings.fast_deblock and cdef_y > 0:
                with span("cdef_rdo"):
                    cdef_y_list, cdef_uv_list, cdef_map, cdef_state = cdef_rdo_frame(
                        rec, frame, frame_blocks, fi.bit_depth,
                        enc.chroma_sampling, enc.width, enc.height,
                        cdef_damping, cdef_y, cdef_uv,
                    )
                if (
                    enc.speed_settings.joint_loop_rdo
                    and use_lrf
                    and cdef_state is not None
                ):
                    # joint CDEF x LRF decision (rdo_loop_decision,
                    # rdo.rs:2104): re-score each CDEF candidate through the
                    # loop-restoration it would get, per 64x64 SB
                    with span("joint_loop_rdo"):
                        cdef_map = self._joint_cdef_map(
                            rec, frame, frame_blocks, fi, enc,
                            deblocked_planes, cdef_damping,
                            cdef_y_list, cdef_uv_list, cdef_state,
                            sb_w, sb_h,
                        )
                cdef_bits = 2
                with span("cdef"):
                    cdef_filter_frame(
                        (cdef_damping, cdef_y_list, cdef_uv_list), rec,
                        frame_blocks, fi.bit_depth, enc.chroma_sampling,
                        enc.width, enc.height, cdef_idx_map=cdef_map,
                        state=cdef_state,
                    )
            else:
                with span("cdef"):
                    cdef_filter_frame(
                        (cdef_damping, cdef_y, cdef_uv), rec, frame_blocks,
                        fi.bit_depth, enc.chroma_sampling, enc.width, enc.height,
                    )

        # Loop restoration: per-LRU SgrProj solve + SSE decision; when any
        # unit selects a filter the tiles are re-encoded with the LRF symbols
        # (the recon is unchanged so pass 2 reproduces pass 1's decisions).
        lrf_types = [0, 0, 0]
        lrf_unit_size = [256, 256, 256]
        if use_lrf:
            from rav1e_tpu.ops.lrf import (
                RESTORE_SWITCHABLE, RestorationState, lrf_decide_units,
                lrf_filter_frame,
            )

            rs = RestorationState.build(
                enc.width, enc.height, enc.chroma_sampling, fi.base_q_idx,
                sb_w, sb_h,
            )
            from rav1e_tpu.ops.lrf import SGRPROJ_FAST_SETS, SGRPROJ_REDUCED_SETS

            _sets = (
                SGRPROJ_REDUCED_SETS
                if enc.speed_settings.joint_loop_rdo
                or not enc.speed_settings.device_analysis
                else SGRPROJ_FAST_SETS
            )
            with span("lrf_decide"):
                lrf_decide_units(
                    rs, rec, deblocked_planes, frame, enc.width, enc.height,
                    fi.bit_depth, enc.chroma_sampling, sets=_sets,
                )
            if rs.any_filters():
                lrf_filter_frame(
                    rs, rec, deblocked_planes, enc.width, enc.height,
                    fi.bit_depth, enc.chroma_sampling,
                )
                lrf_types = [RESTORE_SWITCHABLE] * 3
                lrf_unit_size = [
                    rs.planes[0].cfg.unit_size,
                    rs.planes[1].cfg.unit_size,
                    rs.planes[2].cfg.unit_size,
                ]
            else:
                rs = None
        else:
            rs = None

        # symbols added after pass 1 (per-SB cdef_idx, per-LRU filters)
        # require a tile re-encode.  Pass 2 replays pass 1's recorded RDO
        # decisions, so it normally reproduces the identical block stream
        # cheaply.  The grids are verified below: if they ever drift (a
        # decision point missing from the replay log), the pass-2 recon
        # becomes canonical and the filter chain is re-applied with the
        # already-coded CDEF map and LRF units so encoder refs still match
        # the decoder exactly.
        if cdef_bits > 0 or rs is not None:
            rec_scratch = Frame.new(
                enc.width, enc.height, enc.chroma_sampling, enc.bit_depth
            )
            fb_scratch = FrameBlocks(mi_cols, mi_rows)
            tile_payloads, _, frame_cdfs, _, _ = self._encode_tiles(
                fi, frame, rec_scratch, fb_scratch, mi_cols, mi_rows, rs=rs,
                cdef_bits=cdef_bits, cdef_idx_map=cdef_map, replays=decisions,
                reuse_from=frame_blocks, coeff_logs=coeff_logs,
            )
            tile_group = self._build_tile_group(tile_payloads)

            replay_exact = np.array_equal(
                fb_scratch.skip, frame_blocks.skip
            ) and np.array_equal(fb_scratch.tx_size, frame_blocks.tx_size)
        else:
            replay_exact = True
        if not replay_exact:
            rec = rec_scratch
            frame_blocks = fb_scratch
            deblock_levels = deblock_levels_fast(
                fi.base_q_idx, fi.bit_depth, frame_type == FrameType.KEY,
                tables.ac_q(fi.base_q_idx, 0, fi.bit_depth),
            )
            if not enc.speed_settings.fast_deblock:
                with span("deblock_search_p2"):
                    deblock_levels = deblock_search_levels(
                        deblock_levels, rec, frame, frame_blocks,
                        enc.width, enc.height, fi.bit_depth, enc.chroma_sampling,
                    )
            with span("deblock_p2"):
                deblock_filter_frame(
                    deblock_levels, rec, frame_blocks, enc.width, enc.height,
                    fi.bit_depth, enc.chroma_sampling,
                )
            if rs is not None:
                deblocked_planes = [
                    pl.data[pl.cfg.pad :, pl.cfg.pad :].copy() for pl in rec.planes
                ]
            if self.seq.enable_cdef and cdef_bits > 0:
                with span("cdef_p2"):
                    cdef_filter_frame(
                        (cdef_damping, cdef_y_list, cdef_uv_list), rec,
                        frame_blocks, fi.bit_depth, enc.chroma_sampling,
                        enc.width, enc.height, cdef_idx_map=cdef_map,
                    )
            elif self.seq.enable_cdef and (cdef_y > 0 or cdef_uv > 0):
                with span("cdef_p2"):
                    cdef_filter_frame(
                        (cdef_damping, cdef_y, cdef_uv), rec, frame_blocks,
                        fi.bit_depth, enc.chroma_sampling, enc.width, enc.height,
                    )
            if rs is not None:
                lrf_filter_frame(
                    rs, rec, deblocked_planes, enc.width, enc.height,
                    fi.bit_depth, enc.chroma_sampling,
                )

        return (rec, frame_blocks, enc_stats, frame_cdfs, tile_group,
                deblock_levels, cdef_damping, cdef_bits, cdef_y, cdef_uv,
                cdef_y_list, cdef_uv_list, lrf_types, lrf_unit_size)

    def encode_frame(
        self,
        frame: Frame,
        input_frameno: int,
        frame_type: FrameType,
        params=None,
        is_first: bool = False,
        plan=None,
        next_hints=None,
    ) -> Packet:
        """Copy of rav1e_tpu/encoder/pipeline.py:3164-3582 with the device
        analysis on this pipeline's device and no swallowed device errors."""
        enc = self.config.enc
        assert frame_type == FrameType.KEY or not enc.still_picture

        if plan is None:
            # direct callers without a scheduler: low-latency slot cycling
            from rav1e_tpu.api.inter_cfg import PlannedFrame

            slot = self._fallback_slot % 4
            plan = PlannedFrame(
                "key" if frame_type == FrameType.KEY else "inter",
                input_frameno, order_hint=input_frameno, slot=slot,
                ref_slot_fwd=(slot + 3) % 4,
                ref_frames=[(slot + 3) % 4] * 7,
            )
            self._fallback_slot += 1

        if (
            getattr(plan, "switch", False)
            and frame_type == FrameType.INTER
            and self.rec_buffer[plan.ref_slot_fwd] is not None
        ):
            frame_type = FrameType.SWITCH

        ref_fwd = ref_bwd = ref_bwd2 = None
        primary_ref = 7  # PRIMARY_REF_NONE
        init_cdfs = None
        if frame_type.has_inter():
            ref_fwd = self.rec_buffer[plan.ref_slot_fwd]
            if plan.ref_slot_bwd is not None:
                ref_bwd = self.rec_buffer[plan.ref_slot_bwd]
            if (
                ref_bwd is not None
                and getattr(plan, "ref_slot_bwd2", None) is not None
                and enc.speed_settings.multiref
            ):
                ref_bwd2 = self.rec_buffer[plan.ref_slot_bwd2]
            if ref_fwd is None:
                frame_type = FrameType.KEY
            elif (
                self.cdf_buffer[plan.ref_slot_fwd] is not None
                and not enc.error_resilient
                and frame_type != FrameType.SWITCH
            ):
                # inherit symbol probabilities from the forward reference
                # (primary_ref_frame = LAST; encoder.rs:1040-1046)
                primary_ref = 0
                init_cdfs = self.cdf_buffer[plan.ref_slot_fwd]

        # spec 5.9.8 compute_image_size: mi dims round to EVEN (8px
        # multiples) so 4px edge blocks always pair for chroma coverage
        mi_cols = 2 * ((enc.width + 7) >> 3)
        mi_rows = 2 * ((enc.height + 7) >> 3)

        base_q_idx = self.rc.select_qi(frame_type, enc.width, enc.height, plan.level)

        from rav1e_tpu.config.speed import SegmentationLevel

        ref_luma = None
        seg_enabled = (
            enc.speed_settings.segmentation != SegmentationLevel.Disabled
        )
        memo = getattr(self, "_seg_memo", None)
        if (
            memo is not None
            and frame_type.has_inter()
            and self._chain_applicable()
            and memo[0] == plan.input_frameno
            and memo[1] == frame_type
            and memo[2] == base_q_idx
            and memo[3] == self.slot_src_frameno[plan.ref_slot_fwd]
        ):
            # the chain predispatch already computed this frame's
            # segmentation + dist scales against the same q and fwd ref
            dist_scales, seg = memo[4], memo[5]
        else:
            if frame_type.has_inter() and seg_enabled:
                if self._chain_applicable():
                    # chain tier: the recon lives on device; the SOURCE ref
                    # serves the (encoder-side-only) segmentation heuristic
                    # without forcing a device->host plane fetch
                    ref_luma = self._ref_src_luma(plan.ref_slot_fwd)
                else:
                    ref0 = self.rec_buffer[plan.ref_slot_fwd]
                    if ref0 is not None:
                        ref_luma = ref0.planes[0].as_array()
            dist_scales, seg = self._frame_seg_scales(
                frame, plan, frame_type, base_q_idx, ref_luma
            )

        fi = FrameInvariantsLite(
            seq=self.seq,
            width=enc.width,
            height=enc.height,
            frame_type=frame_type,
            base_q_idx=base_q_idx,
            bit_depth=enc.bit_depth,
            tx_mode_select=True,
            use_reduced_tx_set=enc.speed_settings.transform.reduced_tx_set,
            mi_cols=mi_cols,
            mi_rows=mi_rows,
            ref_frame=ref_fwd if frame_type.has_inter() else None,
            ref_frame_bwd=ref_bwd if frame_type.has_inter() else None,
            ref_frame_bwd2=ref_bwd2 if frame_type.has_inter() else None,
            seg=seg,
            prev_mvs=self.prev_mvs if frame_type.has_inter() else None,
            init_cdfs=init_cdfs if frame_type.has_inter() else None,
        )
        from rav1e_tpu.quantize import chroma_q_deltas

        fi.dc_delta_q, fi.ac_delta_q = chroma_q_deltas(
            base_q_idx, enc.bit_depth, self.seq.chroma_sampling
        )
        fi.dist_scales = dist_scales

        # skip-mode (spec 5.9.22): enabled when the derived closest-ref pair
        # is exactly (LAST, ALTREF) — the pair our compound blocks use
        if fi.is_inter_frame and fi.ref_frame_bwd is not None:
            from rav1e_tpu.encoder.obu import _skip_mode_refs

            class _Probe:
                pass

            _p = _Probe()
            _p.intra_only = False
            _p.reference_mode_select = True
            _p.ref_order_hints = list(self.slot_order_hints)
            _p.ref_frames = list(plan.ref_frames)
            _nb = self.seq.order_hint_bits_minus_1 + 1
            _p.order_hint = plan.order_hint & ((1 << _nb) - 1)
            fi.skip_mode_present = _skip_mode_refs(self.seq, _p) == (0, 6)

        pending = self._pending_analyses.pop(input_frameno, None)
        # validity: the dispatched program must have seen exactly the inputs
        # the sync path would use, so the bitstream is identical whether or
        # not the frame was queued early.  The recorded reference-source
        # framenos must match the slots' actual content (the predispatch
        # simulation can diverge after an unplanned refresh), and the maps
        # additionally require the SAME qi (checked at consumption).
        if pending is not None and not (
            pending["is_inter"] == fi.is_inter_frame
            and (
                not fi.is_inter_frame
                or (
                    pending["ref_fno_fwd"]
                    == self.slot_src_frameno[plan.ref_slot_fwd]
                    and pending["ref_fno_fwd"] is not None
                    and pending["ref_fno_bwd"]
                    == (
                        self.slot_src_frameno[plan.ref_slot_bwd]
                        if (
                            fi.ref_frame_bwd is not None
                            and plan.ref_slot_bwd is not None
                        )
                        else None
                    )
                    and pending.get("ref_fno_bwd2")
                    == (
                        self.slot_src_frameno[plan.ref_slot_bwd2]
                        if (
                            fi.ref_frame_bwd2 is not None
                            and getattr(plan, "ref_slot_bwd2", None)
                            is not None
                        )
                        else None
                    )
                )
            )
        ):
            pending = None

        use_device = (
            enc.speed_settings.device_analysis
            and min(enc.width, enc.height) >= 64
        )

        if fi.is_inter_frame and not use_device and min(enc.width, enc.height) >= 64:
            # no device maps: host hierarchical 3-pass motion fields seed the
            # per-block searches (me.rs:153-284), measured on SOURCE frames
            # like the reference's lookahead ME stats (api/lookahead.rs)
            from rav1e_tpu.context.mv import ALTREF_FRAME, LAST_FRAME
            from rav1e_tpu.encoder.lookahead import hierarchical_me
            from rav1e_tpu.utils.trace import span

            src_y = frame.planes[0].as_array()[: enc.height, : enc.width]
            fields = {}
            with span("hier_me"):
                f0 = self._ref_src_luma(plan.ref_slot_fwd)
                fields[LAST_FRAME] = hierarchical_me(src_y, f0, enc.bit_depth)
                if fi.ref_frame_bwd is not None and plan.ref_slot_bwd is not None:
                    f1 = self._ref_src_luma(plan.ref_slot_bwd)
                    fields[ALTREF_FRAME] = hierarchical_me(
                        src_y, f1, enc.bit_depth
                    )
            fi.me_fields = fields

        # device analysis: one whole-frame device pass decides partitions,
        # intra modes, intra-vs-inter, and the motion field (device/me.py
        # pyramid + subpel SATD); the tile encoders below consume the maps
        # instead of running trial searches
        if use_device:
            from rav1e_tpu.utils.trace import span as _span

            maps = None
            if pending is not None and pending["q"] == base_q_idx:
                with _span("device_analysis"):
                    maps = analyze_finish(pending["handle"])
            if maps is None and self._rc_retry:
                # RC trial re-encode at a corrected qi: reuse the first
                # attempt's maps instead of a second blocking device
                # dispatch when the correction is within the analysis's
                # decision sensitivity (the maps are legal at any qi; at
                # most mildly off-tuned).  One device dispatch per emitted
                # frame (rate.rs needs_trial_encode semantics).
                prev = getattr(self, "_retry_maps", None)
                if (
                    prev is not None
                    and prev[0] == input_frameno
                    and abs(prev[1] - base_q_idx) <= 12
                ):
                    maps = prev[2]
            if maps is not None:
                fi.device_maps = maps
                self._retry_maps = (input_frameno, base_q_idx, maps)
            else:
                src_y = frame.planes[0].as_array()[: enc.height, : enc.width]
                ref_y = ref_y_bwd = ref_y_bwd2 = None
                fno_fwd = fno_bwd = fno_bwd2 = None
                if fi.is_inter_frame:
                    fno_fwd = self.slot_src_frameno[plan.ref_slot_fwd]
                    ref_y = self._ref_src_luma(plan.ref_slot_fwd)
                    if fi.ref_frame_bwd is not None and plan.ref_slot_bwd is not None:
                        fno_bwd = self.slot_src_frameno[plan.ref_slot_bwd]
                        ref_y_bwd = self._ref_src_luma(plan.ref_slot_bwd)
                    if (
                        ref_y_bwd is not None
                        and fi.ref_frame_bwd2 is not None
                        and getattr(plan, "ref_slot_bwd2", None) is not None
                    ):
                        fno_bwd2 = self.slot_src_frameno[plan.ref_slot_bwd2]
                        ref_y_bwd2 = self._ref_src_luma(plan.ref_slot_bwd2)
                q_step = tables.ac_q(base_q_idx, 0, enc.bit_depth) / 8.0
                lam = 0.12 * q_step * q_step
                with _span("device_analysis"):
                    fi.device_maps = analyze_finish(analyze_frame_async(
                        self._dev_luma(input_frameno, src_y),
                        self._dev_luma(fno_fwd, ref_y),
                        self._dev_luma(fno_bwd, ref_y_bwd),
                        base_q_idx, lam,
                        enc.bit_depth,
                        ref2_np=self._dev_luma(fno_bwd2, ref_y_bwd2),
                        device=self.device,
                    ))
                self._retry_maps = (
                    input_frameno, base_q_idx, fi.device_maps
                )
            # launch the NEXT planned frames' analyses now, so their device
            # work overlaps this frame's host coding and loop filters
            if next_hints:
                self._predispatch_analyses(
                    next_hints, frame, frame_type, plan
                )

        chain_out = None
        self._chain_pending_refs = None
        if use_device and fi.is_inter_frame:
            chain_out = self._encode_frame_chain(
                fi, frame, frame_type, plan, input_frameno, base_q_idx,
                next_hints=next_hints)
        if chain_out is None:
            chain_out = self._encode_frame_host(
                fi, frame, frame_type, mi_cols, mi_rows, input_frameno)
        (rec, frame_blocks, enc_stats, frame_cdfs, tile_group,
         deblock_levels, cdef_damping, cdef_bits, cdef_y, cdef_uv,
         cdef_y_list, cdef_uv_list, lrf_types, lrf_unit_size) = chain_out

        sb_w = (mi_cols + MIB_SIZE - 1) // MIB_SIZE
        sb_h = (mi_rows + MIB_SIZE - 1) // MIB_SIZE
        is_inter = fi.is_inter_frame
        n_hint = self.seq.order_hint_bits_minus_1 + 1
        refresh = (
            0xFF
            if frame_type in (FrameType.KEY, FrameType.SWITCH)
            else (1 << plan.slot)
        )
        fh = FrameHeaderInfo(
            width=enc.width,
            height=enc.height,
            frame_type=frame_type,
            intra_only=not is_inter,
            base_q_idx=fi.base_q_idx,
            dc_delta_q=list(fi.dc_delta_q),
            ac_delta_q=list(fi.ac_delta_q),
            tx_mode_select=fi.tx_mode_select,
            use_reduced_tx_set=fi.use_reduced_tx_set,
            sb_width=sb_w,
            sb_height=sb_h,
            order_hint=plan.order_hint & ((1 << n_hint) - 1),
            primary_ref_frame=primary_ref if is_inter else 7,
            reference_mode_select=fi.ref_frame_bwd is not None,
            skip_mode_present=fi.skip_mode_present,
            error_resilient=(enc.error_resilient or frame_type == FrameType.SWITCH) and is_inter,
            ref_order_hints=list(self.slot_order_hints),
            show_frame=plan.show_frame,
            showable_frame=not plan.show_frame,
            allow_screen_content_tools=0,
            force_integer_mv=1 if not is_inter else 0,
            refresh_frame_flags=refresh,
            ref_frames=list(plan.ref_frames),
            allow_high_precision_mv=False,
            is_filter_switchable=False,
            default_filter=0,
            deblock_levels=deblock_levels,
            cdef_damping=cdef_damping,
            cdef_bits=cdef_bits,
            cdef_y_strengths=(
                (cdef_y_list + [0] * 4) if cdef_bits else [cdef_y] + [0] * 7
            ),
            cdef_uv_strengths=(
                (cdef_uv_list + [0] * 4) if cdef_bits else [cdef_uv] + [0] * 7
            ),
            lrf_types=lrf_types,
            lrf_unit_size=lrf_unit_size,
            enable_segmentation=seg is not None,
            segmentation_features=seg.features if seg is not None else None,
            segmentation_data=seg.data if seg is not None else None,
            film_grain_params=(
                enc.film_grain_params[0]
                if self.seq.film_grain_params_present and enc.film_grain_params
                else None
            ),
        )

        packet_data = bytearray()
        packet_data += temporal_delimiter()
        if frame_type == FrameType.KEY:
            packet_data += sequence_header_obu(self.seq)
        if params is not None and plan.show_frame:
            from rav1e_tpu.encoder.obu import metadata_t35_obu

            for t35 in getattr(params, "t35_metadata", ()) or ():
                packet_data += metadata_t35_obu(t35)
        fh_payload = frame_header_payload(self.seq, fh, self.tiling)
        packet_data += wrap_obu(ObuType.OBU_FRAME_HEADER, fh_payload)
        packet_data += wrap_obu(ObuType.OBU_TILE_GROUP, tile_group)

        # trial re-encode (rate.rs needs_trial_encode): an uncalibrated
        # subtype that badly missed its bitrate target re-encodes once at a
        # corrected quantizer; nothing has been committed yet at this point
        if not self._rc_retry and self.rc.needs_trial_encode(
            len(packet_data) * 8, frame_type, plan.level
        ):
            self.rc.observe_trial(
                len(packet_data) * 8, frame_type, fi.base_q_idx,
                enc.width, enc.height, plan.level,
            )
            self._rc_retry = True
            try:
                # `plan` is passed through, so the fallback-plan branch (and
                # its _fallback_slot rotation) does not run a second time:
                # the retry encodes into the same ref slot as the first try.
                return self.encode_frame(
                    frame, input_frameno, frame_type, params, is_first, plan,
                    next_hints=next_hints,
                )
            finally:
                self._rc_retry = False

        rec.pad()
        self.rec_frame = rec
        self.prev_mvs = frame_blocks.mv[:, :, 0, :].copy()
        if frame_cdfs is not None:
            for i in range(8):
                if (refresh >> i) & 1:
                    self.cdf_buffer[i] = frame_cdfs
        n_hint_bits = self.seq.order_hint_bits_minus_1 + 1
        for i in range(8):
            if (refresh >> i) & 1:
                self.slot_order_hints[i] = plan.order_hint & ((1 << n_hint_bits) - 1)
        src_luma = frame.planes[0].as_array()[: enc.height, : enc.width].copy()
        chain_refs = self._chain_pending_refs
        self._chain_pending_refs = None
        for i in range(8):
            if (refresh >> i) & 1:
                self.rec_buffer[i] = rec
                self.src_buffer[i] = src_luma
                self.slot_src_frameno[i] = input_frameno
                # device-chain slot: the chain's own device recon when this
                # frame was chain-coded, else invalidate (lazy re-upload)
                self._chain_slots[i] = chain_refs
        self.frames_encoded += 1
        self.rc.update_state(
            len(packet_data) * 8, frame_type, fi.base_q_idx, enc.width, enc.height,
            plan.level,
        )
        return Packet(
            data=bytes(packet_data),
            input_frameno=input_frameno,
            frame_type=frame_type,
            qp=fi.base_q_idx,
            rec=rec,
            enc_stats=enc_stats,
            opaque=params.opaque if params is not None else None,
            show_frame=plan.show_frame,
        )
