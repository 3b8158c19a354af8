"""Top-level Config of the PyTorch port.

``rav1e_tpu.config.top.Config`` with one more field, ``device``: the torch
device the analysis and the CDEF stage run on.  It has no default and no
fallback: ``"cpu"`` runs the plain PyTorch versions of the kernels, a CUDA
device runs the hand-written kernels, and a CUDA device that is not there is
an error.  ``validate()`` also rejects the settings whose device code is not
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from rav1e_tpu.config import top as _top
from rav1e_tpu.config.top import InvalidConfig


@dataclass
class Config(_top.Config):
    device: Optional[str] = None  # "cpu", "cuda" or "cuda:<index>"

    def validate(self) -> None:
        super().validate()
        self._validate_device()
        if self.enc.speed_settings.device_chain:
            raise InvalidConfig(
                "speed_settings.device_chain=True: the device-chain tier "
                "(rav1e_tpu/device/chain.py) is not ported to rav1e_tpu_torch "
                "yet; set device_chain=False"
            )
        if self.mesh_shape is not None:
            raise InvalidConfig(
                "mesh_shape: the multi-device analysis mesh "
                "(rav1e_tpu/parallel/mesh.py) is not ported to "
                "rav1e_tpu_torch yet"
            )
        if self.parallel_gops > 1:
            raise InvalidConfig(
                "parallel_gops > 1: GOP-parallel encoding is not ported to "
                "rav1e_tpu_torch yet"
            )

    def _validate_device(self) -> None:
        if self.device is None:
            raise InvalidConfig("device is required: 'cpu' or a CUDA device")
        try:
            dev = torch.device(self.device)
        except (RuntimeError, TypeError) as e:
            raise InvalidConfig(f"invalid device {self.device!r}: {e}") from None
        if dev.type == "cpu":
            return
        if dev.type != "cuda":
            raise InvalidConfig(
                f"device {self.device!r}: only 'cpu' and CUDA devices are "
                "supported"
            )
        if not torch.cuda.is_available():
            raise InvalidConfig(f"device {self.device!r}: CUDA is not available")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise InvalidConfig(
                f"device {self.device!r}: only {torch.cuda.device_count()} "
                "CUDA device(s) present"
            )

    def new_context(self):
        """Create an encoding Context running on ``self.device``."""
        self.validate()
        from rav1e_tpu_torch.api.context import Context

        return Context(self)
