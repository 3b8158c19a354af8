"""rav1e_tpu_torch: the PyTorch and CUDA port of rav1e_tpu.

Same public surface as ``rav1e_tpu`` (``Config`` -> ``new_context()`` ->
``send_frame`` / ``flush`` / ``receive_packet``), with the device stage on
PyTorch and two hand-written CUDA kernels for Hopper (``csrc/``), built with
``nvcc`` at first use.  ``Config`` takes an explicit ``device``.  The
JAX-free host layer (symbol coder, tile coders, bitstream writer, decoder)
is imported from ``rav1e_tpu``; nothing here imports JAX.
"""

from rav1e_tpu.api.util import EncoderStatus, FrameType, Packet
from rav1e_tpu.config import (
    ChromaSampling,
    EncoderConfig,
    InvalidConfig,
    SpeedSettings,
)
from rav1e_tpu.frame import Frame, FrameParameters
from rav1e_tpu_torch.api.context import Context
from rav1e_tpu_torch.config import Config

__all__ = [
    "ChromaSampling",
    "Config",
    "Context",
    "EncoderConfig",
    "EncoderStatus",
    "Frame",
    "FrameParameters",
    "FrameType",
    "InvalidConfig",
    "Packet",
    "SpeedSettings",
]
