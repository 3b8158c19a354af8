"""EncoderConfig — settings that affect the produced bitstream.

Behavioral counterpart of the reference's ``src/api/config/encoder.rs``
(same ~30 fields, same defaults, same validation semantics).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from fractions import Fraction
from typing import Optional

from encbench.reference.av1.config.color import (
    ChromaSamplePosition,
    ChromaSampling,
    ColorDescription,
    ContentLight,
    MasteringDisplay,
    PixelRange,
)
from encbench.reference.av1.config.speed import SpeedSettings

# reference: MAX_MAX_KEY_FRAME_INTERVAL (config/encoder.rs:23)
MAX_MAX_KEY_FRAME_INTERVAL = (1 << 31) // 3


class Tune(IntEnum):
    Psnr = 0
    Psychovisual = 1


@dataclass(frozen=True)
class Rational:
    num: int
    den: int

    def as_f64(self) -> float:
        return self.num / self.den

    @classmethod
    def from_reciprocal(cls, r: "Rational") -> "Rational":
        return cls(r.den, r.num)


@dataclass
class EncoderConfig:
    # output size
    width: int = 640
    height: int = 480
    sample_aspect_ratio: Rational = field(default_factory=lambda: Rational(1, 1))
    time_base: Rational = field(default_factory=lambda: Rational(1, 30))

    # data format & color
    bit_depth: int = 8
    chroma_sampling: ChromaSampling = ChromaSampling.Cs420
    chroma_sample_position: ChromaSamplePosition = ChromaSamplePosition.Unknown
    pixel_range: PixelRange = PixelRange.Limited
    color_description: Optional[ColorDescription] = None
    mastering_display: Optional[MasteringDisplay] = None
    content_light: Optional[ContentLight] = None

    level_idx: Optional[int] = None
    enable_timing_info: bool = False
    still_picture: bool = False
    error_resilient: bool = False
    switch_frame_interval: int = 0

    # keyframe / latency
    min_key_frame_interval: int = 12
    max_key_frame_interval: int = 240
    reservoir_frame_delay: Optional[int] = None
    low_latency: bool = False

    # rate control
    quantizer: int = 100
    min_quantizer: int = 0
    bitrate: int = 0
    tune: Tune = Tune.Psnr
    film_grain_params: Optional[list] = None

    # tiling
    tile_cols: int = 0
    tile_rows: int = 0
    tiles: int = 0

    speed_settings: SpeedSettings = field(default_factory=lambda: SpeedSettings.from_preset(6))

    # ---- constructors ------------------------------------------------------

    @classmethod
    def with_speed_preset(cls, speed: int) -> "EncoderConfig":
        return cls(speed_settings=SpeedSettings.from_preset(speed))

    # ---- helpers -----------------------------------------------------------

    def set_key_frame_interval(self, min_interval: int, max_interval: int) -> None:
        self.min_key_frame_interval = min_interval
        self.max_key_frame_interval = (
            MAX_MAX_KEY_FRAME_INTERVAL if max_interval == 0 else max_interval
        )

    def frame_rate(self) -> float:
        return Rational.from_reciprocal(self.time_base).as_f64()

    def render_size(self) -> tuple:
        sar = Fraction(self.sample_aspect_ratio.num, self.sample_aspect_ratio.den)
        if sar > 1:
            return (round(self.width * sar), self.height)
        elif sar < 1 and sar > 0:
            return (self.width, round(self.height / sar))
        return (self.width, self.height)

    @property
    def monochrome(self) -> bool:
        return self.chroma_sampling.is_monochrome()
