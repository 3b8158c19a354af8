"""Sequence-level coding parameters (reference: encoder.rs ``Sequence``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from rav1e_tpu_torch.config import ChromaSampling, ChromaSamplePosition, EncoderConfig, PixelRange


@dataclass
class Sequence:
    profile: int = 0
    still_picture: bool = False
    reduced_still_picture_hdr: bool = False
    level_idx: int = 31  # maximum parameters level by default
    tier: int = 0
    bit_depth: int = 8
    chroma_sampling: ChromaSampling = ChromaSampling.Cs420
    chroma_sample_position: ChromaSamplePosition = ChromaSamplePosition.Unknown
    pixel_range: PixelRange = PixelRange.Limited
    color_description: Optional[object] = None
    mastering_display: Optional[object] = None
    content_light: Optional[object] = None
    max_frame_width: int = 0
    max_frame_height: int = 0
    frame_id_numbers_present_flag: bool = False
    use_128x128_superblock: bool = False
    enable_filter_intra: bool = False
    enable_intra_edge_filter: bool = True
    enable_interintra_compound: bool = False
    enable_masked_compound: bool = False
    enable_warped_motion: bool = False
    enable_dual_filter: bool = False
    enable_order_hint: bool = True
    enable_jnt_comp: bool = False
    enable_ref_frame_mvs: bool = False
    force_screen_content_tools: int = 0
    force_integer_mv: int = 2
    order_hint_bits_minus_1: int = 5
    enable_superres: bool = False
    enable_cdef: bool = True
    enable_restoration: bool = True
    timing_info_present: bool = False
    film_grain_params_present: bool = False
    time_base_num: int = 1
    time_base_den: int = 30
    tiling: Optional[object] = None

    @classmethod
    def from_config(cls, enc: EncoderConfig) -> "Sequence":
        """Reference: Sequence::new (encoder.rs:118-...)"""
        profile = _profile(enc)
        still = enc.still_picture
        s = cls(
            profile=profile,
            still_picture=still,
            reduced_still_picture_hdr=still,
            bit_depth=enc.bit_depth,
            chroma_sampling=enc.chroma_sampling,
            chroma_sample_position=enc.chroma_sample_position,
            pixel_range=enc.pixel_range,
            color_description=enc.color_description,
            mastering_display=enc.mastering_display,
            content_light=enc.content_light,
            max_frame_width=enc.width,
            max_frame_height=enc.height,
            # restoration filters are useless at tiny sizes (encoder.rs)
            enable_cdef=enc.speed_settings.cdef and enc.width >= 32 and enc.height >= 32,
            enable_restoration=enc.speed_settings.lrf and enc.width >= 32 and enc.height >= 32,
            enable_order_hint=not still,
            timing_info_present=enc.enable_timing_info,
            film_grain_params_present=enc.film_grain_params is not None,
            time_base_num=enc.time_base.num,
            time_base_den=enc.time_base.den,
        )
        if still:
            s.force_screen_content_tools = 2
            s.force_integer_mv = 2
            s.enable_order_hint = False
        if enc.level_idx is not None:
            s.level_idx = enc.level_idx
        else:
            # derive the minimal conforming level (levels.rs behavior)
            from rav1e_tpu_torch.config.levels import minimal_level

            s.level_idx = minimal_level(enc.width, enc.height, enc.frame_rate())
        return s


def _profile(enc: EncoderConfig) -> int:
    cs = enc.chroma_sampling
    if enc.bit_depth == 12 or cs == ChromaSampling.Cs422:
        return 2
    if cs == ChromaSampling.Cs444:
        return 1
    return 0
