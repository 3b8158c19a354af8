from rav1e_tpu_torch.api.util import (
    EncoderStatus,
    FrameType,
    FrameTypeOverride,
    Packet,
)
from rav1e_tpu_torch.frame import FrameParameters
from rav1e_tpu_torch.api.context import Context

__all__ = [
    "Context",
    "EncoderStatus",
    "FrameParameters",
    "FrameType",
    "FrameTypeOverride",
    "Packet",
]
