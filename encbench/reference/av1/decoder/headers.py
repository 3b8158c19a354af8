"""OBU / header parsing for the bundled verification decoder.

Mirror of :mod:`rav1e_tpu.encoder.obu` (AV1 spec 5.5-5.12 syntax).  Only the
subset our encoder emits is accepted; anything else raises
:class:`DecodeError` loudly rather than guessing.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from encbench.reference.av1.api.util import FrameType
from encbench.reference.av1.config import ChromaSampling, ChromaSamplePosition, PixelRange
from encbench.reference.av1.encoder.bitio import BitReader
from encbench.reference.av1.encoder.obu import ObuType, PRIMARY_REF_NONE, REF_FRAMES, INTER_REFS_PER_FRAME
from encbench.reference.av1.encoder.sequence import Sequence
from encbench.reference.av1.encoder.tiling import TilingInfo, tile_log2


class DecodeError(ValueError):
    pass


def parse_obus(data: bytes) -> List[Tuple[ObuType, bytes]]:
    out = []
    pos = 0
    while pos < len(data):
        br = BitReader(data[pos:])
        forbidden = br.read_bit()
        if forbidden:
            raise DecodeError("forbidden bit set")
        obu_type = ObuType(br.read(4))
        ext = br.read_bit()
        has_size = br.read_bit()
        br.read_bit()  # reserved
        if ext:
            raise DecodeError("obu extension unsupported")
        if not has_size:
            raise DecodeError("obu without size field")
        size = br.read_uleb128()
        hdr_bytes = br.bytes_consumed()
        payload = data[pos + hdr_bytes : pos + hdr_bytes + size]
        if len(payload) != size:
            raise DecodeError("truncated OBU")
        out.append((obu_type, payload))
        pos += hdr_bytes + size
    return out


def parse_sequence_header(payload: bytes) -> Sequence:
    br = BitReader(payload)
    seq = Sequence()
    seq.profile = br.read(3)
    seq.still_picture = bool(br.read_bit())
    seq.reduced_still_picture_hdr = bool(br.read_bit())
    if seq.reduced_still_picture_hdr:
        seq.level_idx = br.read(5)
        seq.timing_info_present = False
    else:
        seq.timing_info_present = bool(br.read_bit())
        if seq.timing_info_present:
            seq.time_base_num = br.read(32)
            seq.time_base_den = br.read(32)
            if not br.read_bit():
                raise DecodeError("non-equal picture interval unsupported")
            br.read_bit()
            if br.read_bit():
                raise DecodeError("decoder model info unsupported")
        if br.read_bit():
            raise DecodeError("initial display delay unsupported")
        op_cnt = br.read(5)
        if op_cnt != 0:
            raise DecodeError("multiple operating points unsupported")
        br.read(12)
        seq.level_idx = br.read(5)
        if seq.level_idx > 7:
            seq.tier = br.read(1)

    wbits = br.read(4) + 1
    hbits = br.read(4) + 1
    seq.max_frame_width = br.read(wbits) + 1
    seq.max_frame_height = br.read(hbits) + 1

    if not seq.reduced_still_picture_hdr:
        seq.frame_id_numbers_present_flag = bool(br.read_bit())
        if seq.frame_id_numbers_present_flag:
            raise DecodeError("frame id numbers unsupported")
    seq.use_128x128_superblock = bool(br.read_bit())
    seq.enable_filter_intra = bool(br.read_bit())
    seq.enable_intra_edge_filter = bool(br.read_bit())
    if seq.reduced_still_picture_hdr:
        seq.force_screen_content_tools = 2
        seq.force_integer_mv = 2
        seq.enable_order_hint = False
    else:
        seq.enable_interintra_compound = bool(br.read_bit())
        seq.enable_masked_compound = bool(br.read_bit())
        seq.enable_warped_motion = bool(br.read_bit())
        seq.enable_dual_filter = bool(br.read_bit())
        seq.enable_order_hint = bool(br.read_bit())
        if seq.enable_order_hint:
            seq.enable_jnt_comp = bool(br.read_bit())
            seq.enable_ref_frame_mvs = bool(br.read_bit())
        if br.read_bit():
            seq.force_screen_content_tools = 2
        else:
            seq.force_screen_content_tools = br.read_bit()
        if seq.force_screen_content_tools > 0:
            if br.read_bit():
                seq.force_integer_mv = 2
            else:
                seq.force_integer_mv = br.read_bit()
        else:
            seq.force_integer_mv = 2
        if seq.enable_order_hint:
            seq.order_hint_bits_minus_1 = br.read(3)
    seq.enable_superres = bool(br.read_bit())
    seq.enable_cdef = bool(br.read_bit())
    seq.enable_restoration = bool(br.read_bit())

    _parse_color_config(br, seq)
    seq.film_grain_params_present = bool(br.read_bit())
    return seq


def _parse_color_config(br: BitReader, seq: Sequence) -> None:
    high_bitdepth = br.read_bit()
    if seq.profile == 2 and high_bitdepth:
        seq.bit_depth = 12 if br.read_bit() else 10
    else:
        seq.bit_depth = 10 if high_bitdepth else 8
    monochrome = False
    if seq.profile != 1:
        monochrome = bool(br.read_bit())
    has_desc = br.read_bit()
    srgb_triple = False
    if has_desc:
        from encbench.reference.av1.config.color import (
            ColorDescription,
            ColorPrimaries,
            MatrixCoefficients,
            TransferCharacteristics,
        )

        cp = br.read(8)
        tc = br.read(8)
        mc = br.read(8)
        seq.color_description = ColorDescription(
            ColorPrimaries(cp), TransferCharacteristics(tc), MatrixCoefficients(mc)
        )
        srgb_triple = seq.color_description.is_srgb_triple()
    if monochrome or not srgb_triple:
        seq.pixel_range = PixelRange(br.read_bit())
    if monochrome:
        seq.chroma_sampling = ChromaSampling.Cs400
        return
    if srgb_triple:
        seq.chroma_sampling = ChromaSampling.Cs444
        seq.pixel_range = PixelRange.Full
    else:
        if seq.profile == 0:
            seq.chroma_sampling = ChromaSampling.Cs420
        elif seq.profile == 1:
            seq.chroma_sampling = ChromaSampling.Cs444
        else:
            if seq.bit_depth == 12:
                sx = br.read_bit()
                sy = br.read_bit() if sx else 0
                seq.chroma_sampling = {
                    (0, 0): ChromaSampling.Cs444,
                    (1, 0): ChromaSampling.Cs422,
                    (1, 1): ChromaSampling.Cs420,
                }[(sx, sy)]
            else:
                seq.chroma_sampling = ChromaSampling.Cs422
        if seq.chroma_sampling == ChromaSampling.Cs420:
            seq.chroma_sample_position = ChromaSamplePosition(br.read(2))
    br.read_bit()  # separate_uv_delta_q


@dataclass
class FrameHeader:
    frame_type: FrameType = FrameType.KEY
    show_frame: bool = True
    show_existing_frame: bool = False
    frame_to_show_map_idx: int = 0
    error_resilient: bool = False
    intra_only: bool = True
    disable_cdf_update: bool = False
    allow_screen_content_tools: int = 0
    force_integer_mv: int = 1
    order_hint: int = 0
    width: int = 0
    height: int = 0
    allow_intrabc: bool = False
    primary_ref_frame: int = PRIMARY_REF_NONE
    refresh_frame_flags: int = 0xFF
    ref_frames: List[int] = field(default_factory=lambda: [0] * INTER_REFS_PER_FRAME)
    disable_frame_end_update_cdf: bool = False
    base_q_idx: int = 0
    dc_delta_q: List[int] = field(default_factory=lambda: [0, 0, 0])
    ac_delta_q: List[int] = field(default_factory=lambda: [0, 0, 0])
    enable_segmentation: bool = False
    delta_q_present: bool = False
    deblock_levels: List[int] = field(default_factory=lambda: [0, 0, 0, 0])
    deblock_sharpness: int = 0
    cdef_damping: int = 3
    cdef_bits: int = 0
    cdef_y_strengths: List[int] = field(default_factory=lambda: [0] * 8)
    cdef_uv_strengths: List[int] = field(default_factory=lambda: [0] * 8)
    lrf_types: List[int] = field(default_factory=lambda: [0, 0, 0])
    lrf_unit_size: List[int] = field(default_factory=lambda: [256, 128, 128])
    film_grain_params: Optional[object] = None
    segmentation_update_map: bool = True
    segmentation_features: Optional[list] = None
    segmentation_data: Optional[list] = None
    ref_order_hints: List[int] = field(default_factory=lambda: [0] * 8)
    tx_mode_select: bool = False
    reference_mode_select: bool = False
    use_reduced_tx_set: bool = False
    tiling: Optional[TilingInfo] = None
    context_update_tile_id: int = 0
    tile_size_bytes: int = 4


def parse_frame_header(payload: bytes, seq: Sequence, ref_order_hints=None) -> FrameHeader:
    br = BitReader(payload)
    fh = FrameHeader()
    fh.width = seq.max_frame_width
    fh.height = seq.max_frame_height

    if seq.reduced_still_picture_hdr:
        fh.frame_type = FrameType.KEY
        fh.show_frame = True
    else:
        fh.show_existing_frame = bool(br.read_bit())
        if fh.show_existing_frame:
            fh.frame_to_show_map_idx = br.read(3)
            return fh
        fh.frame_type = FrameType(br.read(2))
        fh.show_frame = bool(br.read_bit())
        if not fh.show_frame:
            br.read_bit()  # showable
        if fh.frame_type != FrameType.SWITCH and not (
            fh.frame_type == FrameType.KEY and fh.show_frame
        ):
            fh.error_resilient = bool(br.read_bit())
        elif fh.frame_type == FrameType.SWITCH:
            fh.error_resilient = True  # implied (spec 5.9.2)

    fh.intra_only = fh.frame_type in (FrameType.KEY, FrameType.INTRA_ONLY)
    fh.disable_cdf_update = bool(br.read_bit())
    if seq.force_screen_content_tools == 2:
        fh.allow_screen_content_tools = br.read_bit()
    else:
        fh.allow_screen_content_tools = seq.force_screen_content_tools
    if fh.allow_screen_content_tools > 0 and seq.force_integer_mv == 2:
        fh.force_integer_mv = br.read_bit()
    else:
        fh.force_integer_mv = 0
    if fh.intra_only:
        fh.force_integer_mv = 1

    frame_size_override = False
    if fh.frame_type != FrameType.SWITCH and not seq.reduced_still_picture_hdr:
        frame_size_override = bool(br.read_bit())
    if seq.enable_order_hint:
        fh.order_hint = br.read(seq.order_hint_bits_minus_1 + 1)
    if not fh.error_resilient and not fh.intra_only:
        fh.primary_ref_frame = br.read(3)

    if fh.frame_type == FrameType.KEY:
        fh.refresh_frame_flags = 0xFF
    elif fh.frame_type == FrameType.SWITCH:
        fh.refresh_frame_flags = 0xFF
    else:
        fh.refresh_frame_flags = br.read(REF_FRAMES)

    if (not fh.intra_only or fh.refresh_frame_flags != 0xFF) and (
        fh.error_resilient and seq.enable_order_hint
    ):
        for _ in range(REF_FRAMES):
            br.read(seq.order_hint_bits_minus_1 + 1)

    if fh.intra_only:
        if frame_size_override:
            raise DecodeError("frame size override unsupported")
        # frame size from sequence; superres disabled
        if bool(br.read_bit()):  # render size different
            br.read(16)
            br.read(16)
        if fh.allow_screen_content_tools != 0:
            fh.allow_intrabc = bool(br.read_bit())
    else:
        if seq.enable_order_hint:
            if br.read_bit():
                raise DecodeError("frame_refs_short_signaling unsupported")
        for i in range(INTER_REFS_PER_FRAME):
            fh.ref_frames[i] = br.read(3)
        if fh.frame_type == FrameType.SWITCH or frame_size_override:
            # frame_size_with_refs (spec 5.9.7)
            for _ in range(INTER_REFS_PER_FRAME):
                if br.read_bit():
                    raise DecodeError("found_ref frame sizes unsupported")
            wbits = max((seq.max_frame_width - 1).bit_length(), 1)
            hbits = max((seq.max_frame_height - 1).bit_length(), 1)
            fh.width = br.read(wbits) + 1
            fh.height = br.read(hbits) + 1
            if bool(br.read_bit()):  # render size different
                br.read(16)
                br.read(16)
        elif bool(br.read_bit()):
            br.read(16)
            br.read(16)
        if fh.force_integer_mv == 0:
            br.read_bit()  # allow_high_precision_mv
        if not br.read_bit():  # is_filter_switchable
            br.read(2)
        br.read_bit()  # is_motion_mode_switchable
        if not fh.error_resilient and seq.enable_ref_frame_mvs:
            br.read_bit()

    if not (seq.reduced_still_picture_hdr or fh.disable_cdf_update):
        fh.disable_frame_end_update_cdf = bool(br.read_bit())

    # tile info
    mi_cols = (fh.width + 7 + 0) // 1  # placeholder; computed below
    fh.tiling = _parse_tile_info(br, seq, fh)
    tiles_log2 = fh.tiling.tile_cols_log2 + fh.tiling.tile_rows_log2
    if tiles_log2 > 0:
        fh.context_update_tile_id = br.read(tiles_log2)
        fh.tile_size_bytes = br.read(2) + 1

    # quantization
    fh.base_q_idx = br.read(8)
    fh.dc_delta_q[0] = _read_delta_q(br)
    if seq.chroma_sampling != ChromaSampling.Cs400:
        diff_uv = bool(br.read_bit())
        fh.dc_delta_q[1] = _read_delta_q(br)
        fh.ac_delta_q[1] = _read_delta_q(br)
        if diff_uv:
            fh.dc_delta_q[2] = _read_delta_q(br)
            fh.ac_delta_q[2] = _read_delta_q(br)
        else:
            fh.dc_delta_q[2] = fh.dc_delta_q[1]
            fh.ac_delta_q[2] = fh.ac_delta_q[1]
    if br.read_bit():
        raise DecodeError("qmatrix unsupported")

    fh.enable_segmentation = bool(br.read_bit())
    if fh.enable_segmentation:
        if fh.primary_ref_frame != PRIMARY_REF_NONE:
            update_map = bool(br.read_bit())
            if update_map:
                if br.read_bit():
                    raise DecodeError("temporal segment prediction unsupported")
            update_data = bool(br.read_bit())
        else:
            update_map = update_data = True
        fh.segmentation_update_map = update_map
        if update_data:
            SEG_FEATURE_BITS = [8, 6, 6, 6, 6, 3, 0, 0]
            SEG_FEATURE_SIGNED = [True, True, True, True, True, False, False, False]
            fh.segmentation_features = [[False] * 8 for _ in range(8)]
            fh.segmentation_data = [[0] * 8 for _ in range(8)]
            for i in range(8):
                for j in range(8):
                    if br.read_bit():
                        fh.segmentation_features[i][j] = True
                        bits = SEG_FEATURE_BITS[j]
                        if SEG_FEATURE_SIGNED[j]:
                            fh.segmentation_data[i][j] = br.read_signed(bits + 1)
                        else:
                            fh.segmentation_data[i][j] = br.read(bits)

    fh.delta_q_present = bool(br.read_bit())
    if fh.delta_q_present:
        raise DecodeError("delta q unsupported")

    planes = 1 if seq.chroma_sampling == ChromaSampling.Cs400 else 3
    fh.deblock_levels[0] = br.read(6)
    fh.deblock_levels[1] = br.read(6)
    if planes > 1 and (fh.deblock_levels[0] > 0 or fh.deblock_levels[1] > 0):
        fh.deblock_levels[2] = br.read(6)
        fh.deblock_levels[3] = br.read(6)
    fh.deblock_sharpness = br.read(3)
    if br.read_bit():  # deltas enabled
        if br.read_bit():  # delta updates
            for _ in range(REF_FRAMES):
                if br.read_bit():
                    br.read_signed(7)
            for _ in range(2):
                if br.read_bit():
                    br.read_signed(7)

    if seq.enable_cdef and not fh.allow_intrabc:
        fh.cdef_damping = br.read(2) + 3
        fh.cdef_bits = br.read(2)
        for i in range(1 << fh.cdef_bits):
            fh.cdef_y_strengths[i] = br.read(6)
            if seq.chroma_sampling != ChromaSampling.Cs400:
                fh.cdef_uv_strengths[i] = br.read(6)

    if seq.enable_restoration and not fh.allow_intrabc:
        use_lrf = use_chroma_lrf = False
        for i in range(planes):
            fh.lrf_types[i] = br.read(2)
            if fh.lrf_types[i] != 0:
                use_lrf = True
                if i > 0:
                    use_chroma_lrf = True
        if use_lrf:
            # unit-size shift bits (header.rs:1143-1159 / spec 5.9.20)
            y_unit = 128 if seq.use_128x128_superblock else 64
            if not seq.use_128x128_superblock:
                if br.read(1):
                    y_unit = 128
            if y_unit == 128:
                if br.read(1):
                    y_unit = 256
            uv_unit = y_unit
            if use_chroma_lrf and seq.chroma_sampling == ChromaSampling.Cs420:
                if br.read(1):
                    uv_unit = y_unit >> 1
            fh.lrf_unit_size = [y_unit, uv_unit, uv_unit]

    fh.tx_mode_select = bool(br.read_bit())
    if not fh.intra_only:
        fh.reference_mode_select = bool(br.read_bit())
    from encbench.reference.av1.encoder.obu import _skip_mode_allowed

    fh.ref_order_hints = list(ref_order_hints) if ref_order_hints is not None else [0] * 8
    fh.skip_mode_present = False
    if _skip_mode_allowed(seq, fh):
        fh.skip_mode_present = bool(br.read_bit())
    if not (fh.intra_only or fh.error_resilient or not seq.enable_warped_motion):
        br.read_bit()
    fh.use_reduced_tx_set = bool(br.read_bit())
    if not fh.intra_only:
        for _ in range(7):
            if br.read_bit():
                raise DecodeError("global motion unsupported")
    if seq.film_grain_params_present:
        if br.read_bit():  # apply_grain
            fh.film_grain_params = _read_film_grain(br, seq, fh)
    return fh


def _read_film_grain(br: BitReader, seq, fh):
    """film_grain_params parse (spec 5.9.30; mirror of encoder/obu.py)."""
    from encbench.reference.av1.config import ChromaSampling
    from encbench.reference.av1.config.grain import GrainParams

    gp = GrainParams()
    gp.random_seed = br.read(16)
    if fh.frame_type == FrameType.INTER:
        if not br.read_bit():  # update_grain
            br.read(3)  # film_grain_params_ref_idx (load path unused)
            return gp
    n_y = br.read(4)
    gp.scaling_points_y = [(br.read(8), br.read(8)) for _ in range(n_y)]
    csfl = False
    if seq.chroma_sampling != ChromaSampling.Cs400:
        csfl = bool(br.read_bit())
        gp.chroma_scaling_from_luma = csfl
    if not (
        seq.chroma_sampling == ChromaSampling.Cs400
        or csfl
        or (seq.chroma_sampling == ChromaSampling.Cs420 and not gp.scaling_points_y)
    ):
        n_cb = br.read(4)
        gp.scaling_points_cb = [(br.read(8), br.read(8)) for _ in range(n_cb)]
        n_cr = br.read(4)
        gp.scaling_points_cr = [(br.read(8), br.read(8)) for _ in range(n_cr)]
    gp.scaling_shift = br.read(2) + 8
    gp.ar_coeff_lag = br.read(2)
    num_pos_luma = 2 * gp.ar_coeff_lag * (gp.ar_coeff_lag + 1)
    num_pos_chroma = num_pos_luma
    if gp.scaling_points_y:
        num_pos_chroma = num_pos_luma + 1
        gp.ar_coeffs_y = [br.read(8) - 128 for _ in range(num_pos_luma)]
    if csfl or gp.scaling_points_cb:
        gp.ar_coeffs_cb = [br.read(8) - 128 for _ in range(num_pos_chroma)]
    if csfl or gp.scaling_points_cr:
        gp.ar_coeffs_cr = [br.read(8) - 128 for _ in range(num_pos_chroma)]
    gp.ar_coeff_shift = br.read(2) + 6
    gp.grain_scale_shift = br.read(2)
    if gp.scaling_points_cb:
        gp.cb_mult = br.read(8)
        gp.cb_luma_mult = br.read(8)
        gp.cb_offset = br.read(9)
    if gp.scaling_points_cr:
        gp.cr_mult = br.read(8)
        gp.cr_luma_mult = br.read(8)
        gp.cr_offset = br.read(9)
    gp.overlap_flag = bool(br.read_bit())
    br.read_bit()  # clip_to_restricted_range
    return gp


def _read_delta_q(br: BitReader) -> int:
    if br.read_bit():
        return br.read_signed(7)
    return 0


def _parse_tile_info(br: BitReader, seq: Sequence, fh: FrameHeader) -> TilingInfo:
    sb_size_log2 = 7 if seq.use_128x128_superblock else 6
    uniform = bool(br.read_bit())
    # replicate spec derivation
    from encbench.reference.av1.utils import align_power_of_two, align_power_of_two_and_shift

    frame_w = align_power_of_two(fh.width, 3)
    frame_h = align_power_of_two(fh.height, 3)
    sb_cols = align_power_of_two_and_shift(frame_w, sb_size_log2)
    sb_rows = align_power_of_two_and_shift(frame_h, sb_size_log2)
    from encbench.reference.av1.encoder.tiling import MAX_TILE_AREA, MAX_TILE_COLS, MAX_TILE_ROWS, MAX_TILE_WIDTH

    max_tile_width_sb = MAX_TILE_WIDTH >> sb_size_log2
    max_tile_area_sb = MAX_TILE_AREA >> (2 * sb_size_log2)
    min_tile_cols_log2 = tile_log2(max_tile_width_sb, sb_cols)
    max_tile_cols_log2 = tile_log2(1, min(sb_cols, MAX_TILE_COLS))
    max_tile_rows_log2 = tile_log2(1, min(sb_rows, MAX_TILE_ROWS))
    min_tiles_log2 = max(min_tile_cols_log2, tile_log2(max_tile_area_sb, sb_cols * sb_rows))

    if uniform:
        tile_cols_log2 = min_tile_cols_log2
        while tile_cols_log2 < max_tile_cols_log2:
            if br.read_bit():
                tile_cols_log2 += 1
            else:
                break
        tile_width_sb = align_power_of_two_and_shift(sb_cols, tile_cols_log2)
        cols = (sb_cols + tile_width_sb - 1) // tile_width_sb

        min_tile_rows_log2 = max(min_tiles_log2 - tile_cols_log2, 0)
        tile_rows_log2 = min_tile_rows_log2
        while tile_rows_log2 < max_tile_rows_log2:
            if br.read_bit():
                tile_rows_log2 += 1
            else:
                break
        tile_height_sb = align_power_of_two_and_shift(sb_rows, tile_rows_log2)
        rows = (sb_rows + tile_height_sb - 1) // tile_height_sb
    else:
        # explicit sizes (spec tile_info non-uniform branch); our encoder
        # always emits equal-width tiles, so record the first size
        widest = 0
        sofar = 0
        cols = 0
        tile_width_sb = 0
        while sofar < sb_cols:
            mx = min(max_tile_width_sb, sb_cols - sofar)
            w = br.read_quniform(mx) + 1
            tile_width_sb = max(tile_width_sb, w)
            widest = max(widest, w)
            sofar += w
            cols += 1
        tile_cols_log2 = tile_log2(1, cols)
        if min_tiles_log2 > 0:
            max_tile_area_sb2 = (sb_rows * sb_cols) >> (min_tiles_log2 + 1)
        else:
            max_tile_area_sb2 = sb_rows * sb_cols
        max_tile_height_sb = max(max_tile_area_sb2 // widest, 1)
        sofar = 0
        rows = 0
        tile_height_sb = 0
        while sofar < sb_rows:
            mx = min(max_tile_height_sb, sb_rows - sofar)
            h = br.read_quniform(mx) + 1
            tile_height_sb = max(tile_height_sb, h)
            sofar += h
            rows += 1
        tile_rows_log2 = tile_log2(1, rows)
        min_tile_rows_log2 = max(min_tiles_log2 - tile_cols_log2, 0)

    return TilingInfo(
        frame_width=frame_w,
        frame_height=frame_h,
        tile_width_sb=tile_width_sb,
        tile_height_sb=tile_height_sb,
        cols=cols,
        rows=rows,
        tile_cols_log2=tile_cols_log2,
        tile_rows_log2=tile_rows_log2,
        min_tile_cols_log2=min_tile_cols_log2,
        max_tile_cols_log2=max_tile_cols_log2,
        min_tile_rows_log2=min_tile_rows_log2,
        max_tile_rows_log2=max_tile_rows_log2,
        sb_size_log2=sb_size_log2,
        min_tiles_log2=min_tiles_log2,
    )
