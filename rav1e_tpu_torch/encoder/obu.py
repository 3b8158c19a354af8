"""OBU packaging: sequence header, frame header, tile group, packet assembly.

Behavioral counterpart of the reference's ``src/header.rs`` (uncompressed
header syntax per AV1 spec 5.5-5.12) and the OBU wrapping at
``encoder.rs:3782-3818``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import List, Optional

from rav1e_tpu_torch.api.util import FrameType
from rav1e_tpu_torch.config import ChromaSampling, PixelRange
from rav1e_tpu_torch.encoder.bitio import BitWriter, uleb128
from rav1e_tpu_torch.encoder.sequence import Sequence

PRIMARY_REF_NONE = 7
REF_FRAMES = 8
ALL_REF_FRAMES_MASK = (1 << REF_FRAMES) - 1
INTER_REFS_PER_FRAME = 7


class ObuType(IntEnum):
    OBU_SEQUENCE_HEADER = 1
    OBU_TEMPORAL_DELIMITER = 2
    OBU_FRAME_HEADER = 3
    OBU_TILE_GROUP = 4
    OBU_METADATA = 5
    OBU_FRAME = 6
    OBU_REDUNDANT_FRAME_HEADER = 7
    OBU_PADDING = 15


@dataclass
class FrameHeaderInfo:
    """The frame-level fields the header needs (FrameInvariants-lite)."""

    width: int
    height: int
    frame_type: FrameType = FrameType.KEY
    show_frame: bool = True
    showable_frame: bool = False
    show_existing_frame: bool = False
    frame_to_show_map_idx: int = 0
    error_resilient: bool = False
    intra_only: bool = True
    disable_cdf_update: bool = False
    allow_screen_content_tools: int = 0
    force_integer_mv: int = 1
    frame_size_override_flag: bool = False
    order_hint: int = 0
    primary_ref_frame: int = PRIMARY_REF_NONE
    refresh_frame_flags: int = ALL_REF_FRAMES_MASK
    ref_frames: List[int] = field(default_factory=lambda: [0] * INTER_REFS_PER_FRAME)
    ref_order_hints: List[int] = field(default_factory=lambda: [0] * REF_FRAMES)
    allow_intrabc: bool = False
    allow_high_precision_mv: bool = False
    is_filter_switchable: bool = False
    default_filter: int = 0  # EIGHTTAP_REGULAR
    is_motion_mode_switchable: bool = False
    use_ref_frame_mvs: bool = False
    disable_frame_end_update_cdf: bool = False
    render_and_frame_size_different: bool = False
    render_width: int = 0
    render_height: int = 0
    # quantization
    base_q_idx: int = 100
    dc_delta_q: List[int] = field(default_factory=lambda: [0, 0, 0])
    ac_delta_q: List[int] = field(default_factory=lambda: [0, 0, 0])
    # deblock
    deblock_levels: List[int] = field(default_factory=lambda: [0, 0, 0, 0])
    deblock_sharpness: int = 0
    deblock_deltas_enabled: bool = False
    deblock_delta_updates_enabled: bool = False
    deblock_ref_deltas: List[int] = field(default_factory=lambda: [1, 0, 0, 0, 0, -1, -1, -1])
    deblock_mode_deltas: List[int] = field(default_factory=lambda: [0, 0])
    prev_ref_deltas: List[int] = field(default_factory=lambda: [1, 0, 0, 0, 0, -1, -1, -1])
    prev_mode_deltas: List[int] = field(default_factory=lambda: [0, 0])
    delta_q_present: bool = False
    # cdef
    cdef_damping: int = 3
    cdef_bits: int = 0
    cdef_y_strengths: List[int] = field(default_factory=lambda: [0] * 8)
    cdef_uv_strengths: List[int] = field(default_factory=lambda: [0] * 8)
    # loop restoration: per-plane lrf type (0 = RESTORE_NONE)
    lrf_types: List[int] = field(default_factory=lambda: [0, 0, 0])
    lrf_unit_size: List[int] = field(default_factory=lambda: [256, 128, 128])
    # film grain (None = no grain this frame)
    film_grain_params: Optional[object] = None
    # modes
    tx_mode_select: bool = True
    reference_mode_select: bool = False
    skip_mode_present: bool = False
    use_reduced_tx_set: bool = False
    enable_segmentation: bool = False
    segmentation_update_map: bool = True
    segmentation_update_data: bool = True
    segmentation_features: Optional[list] = None  # [8][SEG_LVL_MAX] bools
    segmentation_data: Optional[list] = None
    # tiling
    sb_width: int = 0
    sb_height: int = 0
    context_update_tile_id: int = 0
    max_tile_size_bytes: int = 4


def write_obu_header(bw: BitWriter, obu_type: ObuType) -> None:
    bw.write_bit(0)  # forbidden
    bw.write(4, int(obu_type))
    bw.write_bit(0)  # extension
    bw.write_bit(1)  # has payload length
    bw.write_bit(0)  # reserved


def metadata_t35_obu(t35) -> bytes:
    """OBU_METADATA with metadata_type ITUT_T35 (spec 5.8.2; header.rs)."""
    out = bytearray()
    out += uleb128(4)  # METADATA_TYPE_ITUT_T35
    out.append(t35.country_code & 0xFF)
    if t35.country_code == 0xFF:
        out.append(t35.country_code_extension_byte & 0xFF)
    out += bytes(t35.data)
    return wrap_obu(ObuType.OBU_METADATA, bytes(out))


def wrap_obu(obu_type: ObuType, payload: bytes) -> bytes:
    bw = BitWriter()
    write_obu_header(bw, obu_type)
    header = bw.done()
    return header + uleb128(len(payload)) + payload


def temporal_delimiter() -> bytes:
    return wrap_obu(ObuType.OBU_TEMPORAL_DELIMITER, b"")


def sequence_header_obu(seq: Sequence) -> bytes:
    return wrap_obu(ObuType.OBU_SEQUENCE_HEADER, sequence_header_payload(seq))


def sequence_header_payload(seq: Sequence) -> bytes:
    bw = BitWriter()
    bw.write(3, seq.profile)
    bw.write_bit(int(seq.still_picture))
    bw.write_bit(int(seq.reduced_still_picture_hdr))
    if seq.reduced_still_picture_hdr:
        bw.write(5, seq.level_idx)
    else:
        bw.write_bit(int(seq.timing_info_present))
        if seq.timing_info_present:
            bw.write(32, seq.time_base_num)
            bw.write(32, seq.time_base_den)
            bw.write_bit(1)  # equal picture interval
            bw.write_bit(1)  # zero interval (num_ticks_per_picture uvlc == 0)
            bw.write_bit(0)  # decoder model info present
        bw.write_bit(0)  # initial display delay present
        bw.write(5, 0)  # operating_points_cnt_minus_1
        bw.write(12, 0)  # operating_point_idc
        bw.write(5, seq.level_idx)
        if seq.level_idx > 7:
            bw.write(1, 0)  # tier

    # frame size bits + max size
    width, height = seq.max_frame_width - 1, seq.max_frame_height - 1
    wbits = max(width.bit_length(), 1)
    hbits = max(height.bit_length(), 1)
    bw.write(4, wbits - 1)
    bw.write(4, hbits - 1)
    bw.write(wbits, width)
    bw.write(hbits, height)

    if not seq.reduced_still_picture_hdr:
        bw.write_bit(int(seq.frame_id_numbers_present_flag))
    bw.write_bit(int(seq.use_128x128_superblock))
    bw.write_bit(int(seq.enable_filter_intra))
    bw.write_bit(int(seq.enable_intra_edge_filter))
    if not seq.reduced_still_picture_hdr:
        bw.write_bit(int(seq.enable_interintra_compound))
        bw.write_bit(int(seq.enable_masked_compound))
        bw.write_bit(int(seq.enable_warped_motion))
        bw.write_bit(int(seq.enable_dual_filter))
        bw.write_bit(int(seq.enable_order_hint))
        if seq.enable_order_hint:
            bw.write_bit(int(seq.enable_jnt_comp))
            bw.write_bit(int(seq.enable_ref_frame_mvs))
        if seq.force_screen_content_tools == 2:
            bw.write_bit(1)
        else:
            bw.write_bit(0)
            bw.write_bit(int(seq.force_screen_content_tools != 0))
        if seq.force_screen_content_tools > 0:
            if seq.force_integer_mv == 2:
                bw.write_bit(1)
            else:
                bw.write_bit(0)
                bw.write_bit(int(seq.force_integer_mv != 0))
        if seq.enable_order_hint:
            bw.write(3, seq.order_hint_bits_minus_1)
    bw.write_bit(int(seq.enable_superres))
    bw.write_bit(int(seq.enable_cdef))
    bw.write_bit(int(seq.enable_restoration))

    _write_color_config(bw, seq)
    bw.write_bit(int(seq.film_grain_params_present))
    # trailing bits
    bw.write_bit(1)
    bw.byte_align()
    return bw.done()


def _write_color_config(bw: BitWriter, seq: Sequence) -> None:
    high_bitdepth = seq.bit_depth > 8
    bw.write_bit(int(high_bitdepth))
    if seq.profile == 2 and high_bitdepth:
        bw.write_bit(int(seq.bit_depth == 12))
    monochrome = seq.chroma_sampling == ChromaSampling.Cs400
    if seq.profile != 1:
        bw.write_bit(int(monochrome))
    srgb_triple = False
    bw.write_bit(int(seq.color_description is not None))
    if seq.color_description is not None:
        cd = seq.color_description
        bw.write(8, int(cd.color_primaries))
        bw.write(8, int(cd.transfer_characteristics))
        bw.write(8, int(cd.matrix_coefficients))
        srgb_triple = cd.is_srgb_triple()
    if monochrome or not srgb_triple:
        bw.write_bit(int(seq.pixel_range == PixelRange.Full))
    if monochrome:
        return
    if not srgb_triple:
        if seq.profile == 2 and seq.bit_depth == 12:
            subsampling_x = seq.chroma_sampling != ChromaSampling.Cs444
            subsampling_y = seq.chroma_sampling == ChromaSampling.Cs420
            bw.write_bit(int(subsampling_x))
            if subsampling_x:
                bw.write_bit(int(subsampling_y))
        if seq.chroma_sampling == ChromaSampling.Cs420:
            bw.write(2, int(seq.chroma_sample_position))
    bw.write_bit(1)  # separate_uv_delta_q


def frame_header_payload(seq: Sequence, fh: FrameHeaderInfo, tiling) -> bytes:
    """Uncompressed frame header (header.rs:462-1141 behavior)."""
    bw = BitWriter()
    if seq.reduced_still_picture_hdr:
        assert fh.frame_type == FrameType.KEY and fh.show_frame
    else:
        bw.write_bit(int(fh.show_existing_frame))
        if fh.show_existing_frame:
            bw.write(3, fh.frame_to_show_map_idx)
            bw.write_bit(1)
            bw.byte_align()
            return bw.done()
        bw.write(2, int(fh.frame_type))
        bw.write_bit(int(fh.show_frame))
        if not fh.show_frame:
            bw.write_bit(int(fh.showable_frame))
        if fh.frame_type != FrameType.SWITCH and not (
            fh.frame_type == FrameType.KEY and fh.show_frame
        ):
            bw.write_bit(int(fh.error_resilient))

    bw.write_bit(int(fh.disable_cdf_update))
    if seq.force_screen_content_tools == 2:
        bw.write_bit(int(fh.allow_screen_content_tools != 0))
    if fh.allow_screen_content_tools > 0 and seq.force_integer_mv == 2:
        bw.write_bit(int(fh.force_integer_mv != 0))

    if fh.frame_type != FrameType.SWITCH and not seq.reduced_still_picture_hdr:
        bw.write_bit(int(fh.frame_size_override_flag))
    if seq.enable_order_hint:
        n = seq.order_hint_bits_minus_1 + 1
        bw.write(n, fh.order_hint & ((1 << n) - 1))
    if not fh.error_resilient and not fh.intra_only:
        bw.write(3, fh.primary_ref_frame)

    if fh.frame_type == FrameType.KEY:
        assert fh.refresh_frame_flags == ALL_REF_FRAMES_MASK or not fh.show_frame
    elif fh.frame_type == FrameType.SWITCH:
        pass
    else:
        bw.write(REF_FRAMES, fh.refresh_frame_flags)

    if (not fh.intra_only or fh.refresh_frame_flags != ALL_REF_FRAMES_MASK) and (
        fh.error_resilient and seq.enable_order_hint
    ):
        for i in range(REF_FRAMES):
            n = seq.order_hint_bits_minus_1 + 1
            bw.write(n, fh.ref_order_hints[i] & ((1 << n) - 1))

    if fh.intra_only:
        _write_frame_size(bw, seq, fh)
        _write_render_size(bw, fh)
        if fh.allow_screen_content_tools != 0:
            bw.write_bit(int(fh.allow_intrabc))
    else:
        if seq.enable_order_hint:
            bw.write_bit(0)  # frame_refs_short_signaling
        for i in range(INTER_REFS_PER_FRAME):
            bw.write(3, fh.ref_frames[i])
        if fh.frame_type == FrameType.SWITCH or fh.frame_size_override_flag:
            # frame_size_with_refs (spec 5.9.7): no ref matches, explicit size
            for _ in range(INTER_REFS_PER_FRAME):
                bw.write_bit(0)  # found_ref
            _write_frame_size(bw, seq, fh, force_override=True)
            _write_render_size(bw, fh)
        else:
            _write_frame_size(bw, seq, fh)
            _write_render_size(bw, fh)
        if fh.force_integer_mv == 0:
            bw.write_bit(int(fh.allow_high_precision_mv))
        bw.write_bit(int(fh.is_filter_switchable))
        if not fh.is_filter_switchable:
            bw.write(2, fh.default_filter)
        bw.write_bit(int(fh.is_motion_mode_switchable))
        if not fh.error_resilient and seq.enable_ref_frame_mvs:
            bw.write_bit(int(fh.use_ref_frame_mvs))

    if not (seq.reduced_still_picture_hdr or fh.disable_cdf_update):
        bw.write_bit(int(fh.disable_frame_end_update_cdf))

    # tile info (uniform spacing; tiling = TilingInfo)
    _write_tile_info(bw, seq, fh, tiling)

    # quantization
    bw.write(8, fh.base_q_idx)
    _write_delta_q(bw, fh.dc_delta_q[0])
    if seq.chroma_sampling != ChromaSampling.Cs400:
        diff_uv_delta = (
            fh.dc_delta_q[1] != fh.dc_delta_q[2] or fh.ac_delta_q[1] != fh.ac_delta_q[2]
        )
        bw.write_bit(int(diff_uv_delta))
        _write_delta_q(bw, fh.dc_delta_q[1])
        _write_delta_q(bw, fh.ac_delta_q[1])
        if diff_uv_delta:
            _write_delta_q(bw, fh.dc_delta_q[2])
            _write_delta_q(bw, fh.ac_delta_q[2])
    bw.write_bit(0)  # using_qmatrix

    # segmentation
    bw.write_bit(int(fh.enable_segmentation))
    if fh.enable_segmentation:
        if fh.primary_ref_frame != PRIMARY_REF_NONE:
            bw.write_bit(int(fh.segmentation_update_map))
            if fh.segmentation_update_map:
                bw.write_bit(0)  # no temporal prediction
            bw.write_bit(int(fh.segmentation_update_data))
        if fh.segmentation_update_data:
            from rav1e_tpu_torch.context.lvmap import NUM_BASE_LEVELS  # noqa: F401

            SEG_FEATURE_BITS = [8, 6, 6, 6, 6, 3, 0, 0]
            SEG_FEATURE_SIGNED = [True, True, True, True, True, False, False, False]
            for i in range(8):
                for j in range(8):
                    on = fh.segmentation_features[i][j]
                    bw.write_bit(int(on))
                    if on:
                        bits = SEG_FEATURE_BITS[j]
                        data = fh.segmentation_data[i][j]
                        if SEG_FEATURE_SIGNED[j]:
                            bw.write_signed(bits + 1, data)
                        else:
                            bw.write(bits, data)

    bw.write_bit(int(fh.delta_q_present))  # delta_q_present_flag
    # delta_lf_params: only coded if delta_q_present
    if fh.delta_q_present:
        raise NotImplementedError("delta q signaling")

    # loop filter params
    planes = 1 if seq.chroma_sampling == ChromaSampling.Cs400 else 3
    bw.write(6, fh.deblock_levels[0])
    bw.write(6, fh.deblock_levels[1])
    if planes > 1 and (fh.deblock_levels[0] > 0 or fh.deblock_levels[1] > 0):
        bw.write(6, fh.deblock_levels[2])
        bw.write(6, fh.deblock_levels[3])
    bw.write(3, fh.deblock_sharpness)
    bw.write_bit(int(fh.deblock_deltas_enabled))
    if fh.deblock_deltas_enabled:
        bw.write_bit(int(fh.deblock_delta_updates_enabled))
        if fh.deblock_delta_updates_enabled:
            for i in range(REF_FRAMES):
                update = fh.deblock_ref_deltas[i] != fh.prev_ref_deltas[i]
                bw.write_bit(int(update))
                if update:
                    bw.write_signed(7, fh.deblock_ref_deltas[i])
            for i in range(2):
                update = fh.deblock_mode_deltas[i] != fh.prev_mode_deltas[i]
                bw.write_bit(int(update))
                if update:
                    bw.write_signed(7, fh.deblock_mode_deltas[i])

    # cdef
    if seq.enable_cdef and not fh.allow_intrabc:
        bw.write(2, fh.cdef_damping - 3)
        bw.write(2, fh.cdef_bits)
        for i in range(1 << fh.cdef_bits):
            bw.write(6, fh.cdef_y_strengths[i])
            if seq.chroma_sampling != ChromaSampling.Cs400:
                bw.write(6, fh.cdef_uv_strengths[i])

    # loop restoration
    if seq.enable_restoration and not fh.allow_intrabc:
        use_lrf = False
        use_chroma_lrf = False
        for i in range(planes):
            bw.write(2, fh.lrf_types[i])
            if fh.lrf_types[i] != 0:
                use_lrf = True
                if i > 0:
                    use_chroma_lrf = True
        if use_lrf:
            if not seq.use_128x128_superblock:
                bw.write(1, int(fh.lrf_unit_size[0] > 64))
            if fh.lrf_unit_size[0] > 64:
                bw.write(1, int(fh.lrf_unit_size[0] > 128))
            if use_chroma_lrf and seq.chroma_sampling == ChromaSampling.Cs420:
                bw.write(1, int(fh.lrf_unit_size[0] > fh.lrf_unit_size[1]))

    bw.write_bit(int(fh.tx_mode_select))
    if not fh.intra_only:
        bw.write_bit(int(fh.reference_mode_select))
    # skip mode (spec 5.9.22; reference header.rs skip-mode arm)
    skip_mode_allowed = _skip_mode_allowed(seq, fh)
    if skip_mode_allowed:
        bw.write_bit(int(fh.skip_mode_present))
    if not (fh.intra_only or fh.error_resilient or not seq.enable_warped_motion):
        bw.write_bit(0)  # allow_warped_motion
    bw.write_bit(int(fh.use_reduced_tx_set))

    # global motion: all IDENTITY
    if not fh.intra_only:
        for _ in range(7):
            bw.write_bit(0)

    if seq.film_grain_params_present:
        gp = fh.film_grain_params
        if gp is None:
            bw.write_bit(0)  # no grain for this frame
        else:
            _write_film_grain(bw, seq, fh, gp)

    bw.write_bit(1)  # trailing
    bw.byte_align()
    return bw.done()


def _write_film_grain(bw: BitWriter, seq: Sequence, fh: FrameHeaderInfo, gp) -> None:
    """film_grain_params syntax (spec 5.9.30; reference header.rs:839-935)."""
    bw.write_bit(1)  # apply_grain
    bw.write(16, gp.random_seed & 0xFFFF)
    if fh.frame_type == FrameType.INTER:
        bw.write_bit(1)  # update_grain (always re-send; header.rs:844-849)

    bw.write(4, len(gp.scaling_points_y))
    for v, s in gp.scaling_points_y:
        bw.write(8, v)
        bw.write(8, s)

    csfl = False
    if seq.chroma_sampling != ChromaSampling.Cs400:
        csfl = bool(gp.chroma_scaling_from_luma)
        bw.write_bit(int(csfl))
    if not (
        seq.chroma_sampling == ChromaSampling.Cs400
        or csfl
        or (seq.chroma_sampling == ChromaSampling.Cs420 and not gp.scaling_points_y)
    ):
        bw.write(4, len(gp.scaling_points_cb))
        for v, s in gp.scaling_points_cb:
            bw.write(8, v)
            bw.write(8, s)
        bw.write(4, len(gp.scaling_points_cr))
        for v, s in gp.scaling_points_cr:
            bw.write(8, v)
            bw.write(8, s)

    bw.write(2, gp.scaling_shift - 8)
    bw.write(2, gp.ar_coeff_lag)
    num_pos_luma = 2 * gp.ar_coeff_lag * (gp.ar_coeff_lag + 1)
    num_pos_chroma = num_pos_luma
    if gp.scaling_points_y:
        num_pos_chroma = num_pos_luma + 1
        for i in range(num_pos_luma):
            bw.write(8, (gp.ar_coeffs_y[i] + 128) & 0xFF)
    if csfl or gp.scaling_points_cb:
        for i in range(num_pos_chroma):
            bw.write(8, (gp.ar_coeffs_cb[i] + 128) & 0xFF)
    if csfl or gp.scaling_points_cr:
        for i in range(num_pos_chroma):
            bw.write(8, (gp.ar_coeffs_cr[i] + 128) & 0xFF)
    bw.write(2, gp.ar_coeff_shift - 6)
    bw.write(2, gp.grain_scale_shift)
    if gp.scaling_points_cb:
        bw.write(8, gp.cb_mult)
        bw.write(8, gp.cb_luma_mult)
        bw.write(9, gp.cb_offset)
    if gp.scaling_points_cr:
        bw.write(8, gp.cr_mult)
        bw.write(8, gp.cr_luma_mult)
        bw.write(9, gp.cr_offset)
    bw.write_bit(int(gp.overlap_flag))
    from rav1e_tpu_torch.config import PixelRange

    bw.write_bit(int(seq.pixel_range == PixelRange.Limited))


def _skip_mode_refs(seq: Sequence, fh: FrameHeaderInfo):
    """Spec 7.8 skip-mode derivation (reference Sequence::get_skip_mode_allowed):
    the (forward, backward) reference-list indices of the closest refs by
    order hint, or None when skip mode is not allowed."""
    if fh.intra_only or not fh.reference_mode_select or not seq.enable_order_hint:
        return None
    bits = seq.order_hint_bits_minus_1 + 1

    def rel(a, b):
        d = (a - b) & ((1 << bits) - 1)
        m = 1 << (bits - 1)
        return (d & (m - 1)) - (d & m)

    fwd = bwd = None
    fwd_i = bwd_i = -1
    for i in range(INTER_REFS_PER_FRAME):
        hint = fh.ref_order_hints[fh.ref_frames[i]]
        if rel(hint, fh.order_hint) < 0:
            if fwd is None or rel(hint, fwd) > 0:
                fwd, fwd_i = hint, i
        elif rel(hint, fh.order_hint) > 0:
            if bwd is None or rel(hint, bwd) < 0:
                bwd, bwd_i = hint, i
    if fwd is None or bwd is None:
        return None
    return (fwd_i, bwd_i)


def _skip_mode_allowed(seq: Sequence, fh: FrameHeaderInfo) -> bool:
    return _skip_mode_refs(seq, fh) is not None


def _write_frame_size(bw: BitWriter, seq: Sequence, fh: FrameHeaderInfo, force_override=False) -> None:
    if fh.frame_size_override_flag or force_override:
        # bit widths come from the sequence header (spec 5.9.5 frame_size)
        wbits = max((seq.max_frame_width - 1).bit_length(), 1)
        hbits = max((seq.max_frame_height - 1).bit_length(), 1)
        bw.write(wbits, fh.width - 1)
        bw.write(hbits, fh.height - 1)
    # superres disabled (not written when disabled in sequence)


def _write_render_size(bw: BitWriter, fh: FrameHeaderInfo) -> None:
    bw.write_bit(int(fh.render_and_frame_size_different))
    if fh.render_and_frame_size_different:
        bw.write(16, fh.render_width - 1)
        bw.write(16, fh.render_height - 1)


def _write_delta_q(bw: BitWriter, delta_q: int) -> None:
    bw.write_bit(int(delta_q != 0))
    if delta_q != 0:
        bw.write_signed(7, delta_q)


def _write_tile_info(bw: BitWriter, seq: Sequence, fh: FrameHeaderInfo, tiling) -> None:
    """Uniform tile spacing syntax (header.rs:667-737)."""
    from rav1e_tpu_torch.encoder.tiling import MAX_TILE_WIDTH
    from rav1e_tpu_torch.utils import align_power_of_two_and_shift

    ti = tiling
    uniform = (
        align_power_of_two_and_shift(fh.sb_width, ti.tile_cols_log2) == ti.tile_width_sb
        and align_power_of_two_and_shift(fh.sb_height, ti.tile_rows_log2) == ti.tile_height_sb
    )
    bw.write_bit(int(uniform))
    if uniform:
        for _ in range(ti.tile_cols_log2 - ti.min_tile_cols_log2):
            bw.write_bit(1)
        if ti.tile_cols_log2 < ti.max_tile_cols_log2:
            bw.write_bit(0)
        for _ in range(ti.tile_rows_log2 - ti.min_tile_rows_log2):
            bw.write_bit(1)
        if ti.tile_rows_log2 < ti.max_tile_rows_log2:
            bw.write_bit(0)
    else:
        # explicit widths/heights (header.rs:708-737)
        sb_shift = 7 if seq.use_128x128_superblock else 6
        sofar = 0
        widest = 0
        for _ in range(ti.cols):
            mx = min(MAX_TILE_WIDTH >> sb_shift, fh.sb_width - sofar)
            this_w = min(ti.tile_width_sb, fh.sb_width - sofar)
            bw.write_quniform(mx, this_w - 1)
            sofar += this_w
            widest = max(widest, this_w)
        if ti.min_tiles_log2 > 0:
            max_tile_area_sb = (fh.sb_height * fh.sb_width) >> (ti.min_tiles_log2 + 1)
        else:
            max_tile_area_sb = fh.sb_height * fh.sb_width
        max_tile_height_sb = max(max_tile_area_sb // widest, 1)
        sofar = 0
        for _ in range(ti.rows):
            mx = min(max_tile_height_sb, fh.sb_height - sofar)
            this_h = min(ti.tile_height_sb, fh.sb_height - sofar)
            bw.write_quniform(mx, this_h - 1)
            sofar += this_h
    tiles_log2 = ti.tile_cols_log2 + ti.tile_rows_log2
    if tiles_log2 > 0:
        bw.write(tiles_log2, fh.context_update_tile_id)
        bw.write(2, fh.max_tile_size_bytes - 1)


def av1_codec_configuration_record(enc) -> bytes:
    """AV1CodecConfigurationRecord (reference api/context.rs:341)."""
    seq = Sequence.from_config(enc)
    payload = sequence_header_payload(seq)
    bw = BitWriter()
    bw.write_bit(1)  # marker
    bw.write(7, 1)  # version
    bw.write(3, seq.profile)
    bw.write(5, seq.level_idx)
    bw.write_bit(seq.tier)
    bw.write_bit(int(seq.bit_depth > 8))
    bw.write_bit(int(seq.bit_depth == 12))
    bw.write_bit(int(seq.chroma_sampling == ChromaSampling.Cs400))
    sx, sy = seq.chroma_sampling.sub_sampling()
    bw.write_bit(sx)
    bw.write_bit(sy)
    bw.write(2, int(seq.chroma_sample_position))
    bw.write(3, 0)  # reserved
    bw.write_bit(0)  # initial_presentation_delay_present
    bw.write(4, 0)
    return bw.done() + wrap_obu(ObuType.OBU_SEQUENCE_HEADER, payload)
