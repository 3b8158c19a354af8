"""Top-level Config: pairs an EncoderConfig with runtime resources.

Counterpart of the reference's ``src/api/config/mod.rs`` (``Config`` builder,
``validate()``, ``new_context()``).  Where the reference configures a rayon
thread pool, ``with_mesh`` names a device mesh (``mesh_shape``).  It is
accepted and carried as ``rav1e_tpu`` carries it, and the pipeline does not
read it: the analysis shards over every visible card on its own
(``rav1e_tpu_torch.device.analysis._analysis_mesh``).

The PyTorch port's copy adds ``device``, the torch device of the device
stage (``"cuda"`` unless the caller asks for ``"cpu"``).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

from rav1e_tpu_torch.config.encoder import EncoderConfig, MAX_MAX_KEY_FRAME_INTERVAL
from rav1e_tpu_torch.config.speed import SpeedSettings


class InvalidConfig(ValueError):
    """Raised by Config.validate() (reference: ``InvalidConfig`` enum,
    config/mod.rs:34-130)."""


@dataclass
class RateControlConfig:
    """Multi-pass rate-control plumbing (reference: ``config/rate.rs``)."""

    emit_pass_data: bool = False
    summary: Optional[object] = None  # RCSummary from a previous pass


@dataclass
class Config:
    enc: EncoderConfig = field(default_factory=EncoderConfig)
    rate_control: RateControlConfig = field(default_factory=RateControlConfig)
    # Device parallelism: None = all local devices in one data axis.
    mesh_shape: Optional[dict] = None  # e.g. {"tile": 4, "gop": 2}
    threads: int = 0  # host worker threads for EC / IO overlap (0 = auto)
    parallel_gops: int = 0  # >0 enables GOP-parallel encoding slots
    # torch device of the analysis and the CDEF stage: "cuda" (the default),
    # "cuda:<index>", or "cpu", which runs the kernels' plain PyTorch
    # versions and is asked for explicitly.  A CUDA device that is not there
    # is an error: nothing falls back to the CPU.
    device: str = "cuda"

    # ---- builder-style helpers (mirror reference Config::with_*) ----------

    def with_encoder_config(self, enc: EncoderConfig) -> "Config":
        return replace(self, enc=enc)

    def with_speed_preset(self, speed: int) -> "Config":
        cfg = replace(self)
        cfg.enc = replace(cfg.enc, speed_settings=SpeedSettings.from_preset(speed))
        return cfg

    def with_threads(self, threads: int) -> "Config":
        return replace(self, threads=threads)

    def with_parallel_gops(self, slots: int) -> "Config":
        return replace(self, parallel_gops=slots)

    def new_channel(self):
        """Push-style (sender, receiver) channel; GOP-parallel when
        ``parallel_gops > 1`` (reference api/channel/mod.rs:54)."""
        from rav1e_tpu_torch.api.channel import new_channel

        return new_channel(self)

    def with_rate_control(self, rc: RateControlConfig) -> "Config":
        return replace(self, rate_control=rc)

    def with_mesh(self, **axes: int) -> "Config":
        return replace(self, mesh_shape=dict(axes))

    # ---- validation (reference: config/mod.rs:305-449) ---------------------

    def validate(self) -> None:
        e = self.enc
        if e.width < 16 or e.width > 65535 or e.height < 16 or e.height > 65535:
            raise InvalidConfig(f"invalid dimensions {e.width}x{e.height}")
        if e.bit_depth not in (8, 10, 12):
            raise InvalidConfig(f"invalid bit depth {e.bit_depth}")
        if e.bit_depth == 12 and e.chroma_sampling.name not in ("Cs420", "Cs444", "Cs400"):
            # profile 2 (12-bit) allows all samplings; 10-bit 4:2:2 needs profile 2 too.
            pass
        if e.quantizer > 255:
            raise InvalidConfig(f"quantizer {e.quantizer} out of range [0, 255]")
        if e.still_picture and e.low_latency is False and e.max_key_frame_interval > 1:
            # still picture implies a single frame; normalize rather than error
            pass
        if e.max_key_frame_interval > MAX_MAX_KEY_FRAME_INTERVAL:
            raise InvalidConfig("max_key_frame_interval too large")
        if e.min_key_frame_interval > e.max_key_frame_interval:
            raise InvalidConfig("min_key_frame_interval > max_key_frame_interval")
        if e.bitrate < 0:
            raise InvalidConfig("negative bitrate")
        if e.switch_frame_interval > 0 and not e.low_latency:
            raise InvalidConfig("switch frames require low latency mode")
        if e.tile_cols and (e.tile_cols & (e.tile_cols - 1)):
            raise InvalidConfig("tile_cols must be a power of 2")
        if e.tile_rows and (e.tile_rows & (e.tile_rows - 1)):
            raise InvalidConfig("tile_rows must be a power of 2")
        sp = e.speed_settings.partition.partition_range
        if not (2 <= sp.min_log2 <= sp.max_log2 <= 6):
            raise InvalidConfig("invalid partition range")
        if e.level_idx is not None:
            from rav1e_tpu_torch.config.levels import check_level

            err = check_level(e.width, e.height, e.frame_rate(), e.level_idx)
            if err is not None:
                raise InvalidConfig(f"AV1 level violation: {err}")
        self._validate_device()

    def _validate_device(self) -> None:
        import torch

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

    # ---- context construction ---------------------------------------------

    def new_context(self):
        """Create an encoding Context (reference: config/mod.rs:292)."""
        self.validate()
        from rav1e_tpu_torch.api.context import Context

        return Context(self)
