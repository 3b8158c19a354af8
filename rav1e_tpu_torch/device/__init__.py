"""Device compute stage of the PyTorch port.

Counterpart of ``rav1e_tpu/device``: one whole-frame analysis per frame
(device motion estimation, 13-mode intra scoring, transform-domain rate and
distortion estimates, bottom-up partition merge) and the device CDEF stage,
on PyTorch tensors with two hand-written CUDA kernels (``kernels.satd8``,
``kernels.grid_search``).  The port's host tile coders consume the resulting
decision maps.
"""

from rav1e_tpu_torch.device.analysis import (
    DeviceMaps,
    analyze_finish,
    analyze_frame,
    analyze_frame_async,
    upload_source_luma,
)
from rav1e_tpu_torch.device.filters import cdef_device_frame

__all__ = [
    "DeviceMaps", "analyze_finish", "analyze_frame", "analyze_frame_async",
    "cdef_device_frame", "upload_source_luma",
]
