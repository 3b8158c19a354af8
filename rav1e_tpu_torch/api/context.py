"""Pull-based encoding context of the PyTorch port.

``rav1e_tpu.api.context.Context`` with the port's frame pipeline: frames go
in through ``send_frame``, packets come out of ``receive_packet``.  The
frame scheduler (``ContextInner``) is the reference's own.
"""

from __future__ import annotations

from rav1e_tpu.api import context as _ref
from rav1e_tpu_torch.encoder.pipeline import FramePipeline


class Context(_ref.Context):
    """Encoding context created by :meth:`rav1e_tpu_torch.Config.new_context`."""

    def __init__(self, config):
        self.config = config
        self.is_flushing = False
        self.inner = _ref.ContextInner(config)
        self.pipeline = FramePipeline(config)
