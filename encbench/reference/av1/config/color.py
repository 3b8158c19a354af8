"""Color configuration types (reference: ``src/api/color.rs``)."""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum


class ChromaSampling(IntEnum):
    """Chroma subsampling format."""

    Cs420 = 0
    Cs422 = 1
    Cs444 = 2
    Cs400 = 3  # monochrome

    def decimation(self) -> tuple:
        """(xdec, ydec) log2 decimation for chroma planes."""
        return {
            ChromaSampling.Cs420: (1, 1),
            ChromaSampling.Cs422: (1, 0),
            ChromaSampling.Cs444: (0, 0),
            ChromaSampling.Cs400: (1, 1),
        }[self]

    def is_monochrome(self) -> bool:
        return self is ChromaSampling.Cs400

    def sub_sampling(self) -> tuple:
        """(subsampling_x, subsampling_y) flags as signaled in the sequence header."""
        xdec, ydec = self.decimation()
        return (xdec, ydec)


class ChromaSamplePosition(IntEnum):
    Unknown = 0
    Vertical = 1  # co-located with luma(0,0), vertically centered
    Colocated = 2


class PixelRange(IntEnum):
    Limited = 0
    Full = 1


class ColorPrimaries(IntEnum):
    BT709 = 1
    Unspecified = 2
    BT470M = 4
    BT470BG = 5
    BT601 = 6
    SMPTE240 = 7
    GenericFilm = 8
    BT2020 = 9
    XYZ = 10
    SMPTE431 = 11
    SMPTE432 = 12
    EBU3213 = 22


class TransferCharacteristics(IntEnum):
    BT709 = 1
    Unspecified = 2
    BT470M = 4
    BT470BG = 5
    BT601 = 6
    SMPTE240 = 7
    Linear = 8
    Log100 = 9
    Log100Sqrt10 = 10
    IEC61966 = 11
    BT1361 = 12
    SRGB = 13
    BT2020_10Bit = 14
    BT2020_12Bit = 15
    SMPTE2084 = 16
    SMPTE428 = 17
    HLG = 18


class MatrixCoefficients(IntEnum):
    Identity = 0
    BT709 = 1
    Unspecified = 2
    FCC = 4
    BT470BG = 5
    BT601 = 6
    SMPTE240 = 7
    YCgCo = 8
    BT2020NCL = 9
    BT2020CL = 10
    SMPTE2085 = 11
    ChromatNCL = 12
    ChromatCL = 13
    ICtCp = 14


@dataclass(frozen=True)
class ColorDescription:
    color_primaries: ColorPrimaries = ColorPrimaries.Unspecified
    transfer_characteristics: TransferCharacteristics = TransferCharacteristics.Unspecified
    matrix_coefficients: MatrixCoefficients = MatrixCoefficients.Unspecified

    def is_srgb_triple(self) -> bool:
        return (
            self.color_primaries == ColorPrimaries.BT709
            and self.transfer_characteristics == TransferCharacteristics.SRGB
            and self.matrix_coefficients == MatrixCoefficients.Identity
        )


@dataclass(frozen=True)
class ChromaticityPoint:
    x: int = 0
    y: int = 0


@dataclass(frozen=True)
class MasteringDisplay:
    primaries: tuple = (ChromaticityPoint(), ChromaticityPoint(), ChromaticityPoint())
    white_point: ChromaticityPoint = ChromaticityPoint()
    max_luminance: int = 0
    min_luminance: int = 0


@dataclass(frozen=True)
class ContentLight:
    max_content_light_level: int = 0
    max_frame_average_light_level: int = 0
