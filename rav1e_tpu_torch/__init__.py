"""rav1e_tpu_torch: the PyTorch and CUDA port of rav1e_tpu.

Same public surface as ``rav1e_tpu`` (``Config`` -> ``new_context()`` ->
``send_frame`` / ``flush`` / ``receive_packet``), with the device stage on
PyTorch and hand-written CUDA kernels for Hopper (``csrc/``), built with
``nvcc`` at first use.  ``Config.device`` is ``"cuda"`` unless the caller
asks for ``"cpu"``.  The package carries its own copy of the host layer
(symbol coder, tile coders, bitstream writer, rate control, decoder in
``rav1e_tpu_torch.decoder``) and imports nothing of ``rav1e_tpu`` and
nothing of JAX.
"""

__version__ = "0.1.0"

from rav1e_tpu_torch.config import (
    ChromaSampling,
    ChromaSamplePosition,
    Config,
    EncoderConfig,
    InvalidConfig,
    PixelRange,
    RateControlConfig,
    SpeedSettings,
    Tune,
)
from rav1e_tpu_torch.api import (
    Context,
    EncoderStatus,
    Packet,
    FrameType,
    FrameTypeOverride,
    FrameParameters,
)
from rav1e_tpu_torch.frame import Frame, Plane

__all__ = [
    "ChromaSampling",
    "ChromaSamplePosition",
    "Config",
    "Context",
    "EncoderConfig",
    "EncoderStatus",
    "Frame",
    "FrameParameters",
    "InvalidConfig",
    "FrameType",
    "FrameTypeOverride",
    "Packet",
    "PixelRange",
    "Plane",
    "RateControlConfig",
    "SpeedSettings",
    "Tune",
]
