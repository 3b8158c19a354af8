from encbench.reference.av1.config.color import (
    ChromaSamplePosition,
    ChromaSampling,
    ColorDescription,
    ColorPrimaries,
    ContentLight,
    MasteringDisplay,
    MatrixCoefficients,
    PixelRange,
    TransferCharacteristics,
)
from encbench.reference.av1.config.encoder import EncoderConfig, Rational, Tune

__all__ = [
    "ChromaSamplePosition",
    "ChromaSampling",
    "ColorDescription",
    "ColorPrimaries",
    "ContentLight",
    "EncoderConfig",
    "MasteringDisplay",
    "MatrixCoefficients",
    "PixelRange",
    "Rational",
    "TransferCharacteristics",
    "Tune",
]
