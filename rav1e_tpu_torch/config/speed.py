"""Speed/quality trade-off settings.

Behavioral counterpart of the reference's
``src/api/config/speedsettings.rs`` — same presets 0..=10, same knobs, so a
rav1e user finds the identical speed surface (``SpeedSettings.from_preset``
mirrors ``speedsettings.rs:115-198``).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from enum import IntEnum


class SceneDetectionSpeed(IntEnum):
    """How precisely to detect scene changes."""

    Fast = 0  # pixel-difference heuristic only
    Standard = 1  # inter/intra cost comparison
    NoDetection = 2


class PredictionModesSetting(IntEnum):
    Simple = 0
    ComplexKeyframes = 1
    ComplexAll = 2


class SGRComplexityLevel(IntEnum):
    Full = 0
    Reduced = 1


class SegmentationLevel(IntEnum):
    Disabled = 0
    Simple = 1
    Complex = 2
    Full = 3


# Block size names as strings keep this module free of a dependency on the
# partition module; PartitionRange stores log2 sizes.
@dataclass(frozen=True)
class PartitionRange:
    """Inclusive range of square partition sizes searched, as log2 side."""

    min_log2: int = 2  # 4x4
    max_log2: int = 6  # 64x64

    def __post_init__(self):
        assert 2 <= self.min_log2 <= self.max_log2 <= 6


@dataclass
class TransformSpeedSettings:
    reduced_tx_set: bool = False
    tx_domain_distortion: bool = True
    tx_domain_rate: bool = False
    rdo_tx_decision: bool = True
    # trial every member of the allowed TxSet (reference
    # rdo_tx_type_decision, rdo.rs:1701) instead of DCT-vs-mode-preferred
    full_tx_type_search: bool = True
    enable_inter_tx_split: bool = False


@dataclass
class PartitionSpeedSettings:
    encode_bottomup: bool = True
    non_square_partition_max_threshold_log2: int = 6  # 64x64 == allow everywhere
    partition_range: PartitionRange = field(default_factory=PartitionRange)


@dataclass
class MotionSpeedSettings:
    use_satd_subpel: bool = True
    include_near_mvs: bool = True
    me_allow_full_search: bool = True
    # full-pel search family (reference me.rs:955-1511): 0 diamond,
    # 1 + hexagon refine, 2 + uneven multi-hex, 3 + exhaustive window
    me_method: int = 3
    me_range: int = 16


@dataclass
class PredictionSpeedSettings:
    prediction_modes: PredictionModesSetting = PredictionModesSetting.ComplexAll
    fine_directional_intra: bool = True


@dataclass
class SpeedSettings:
    multiref: bool = True
    temporal_rdo: bool = True
    # Use the batched device (TPU) analysis stage for partition + intra-mode
    # decisions instead of host trial encodes.  On at the presets that do
    # not run full trial RDO; the trial path remains the quality tier.
    device_analysis: bool = False
    # Device-resident reconstruction chain (device/chain.py): the whole
    # inter-frame recon path (selection/MC/tx/quant/recon/deblock/CDEF) as
    # one async XLA dispatch, refs kept on device, host runs only the
    # pixel-free native replay coder.  The throughput tier.
    device_chain: bool = False
    fast_deblock: bool = False
    rdo_lookahead_frames: int = 40
    scene_detection_mode: SceneDetectionSpeed = SceneDetectionSpeed.Standard
    cdef: bool = True
    lrf: bool = True
    # score CDEF candidates through the loop-restoration output (the joint
    # rdo_loop_decision of rdo.rs:2104) instead of deciding them separately
    joint_loop_rdo: bool = True
    lru_on_skip: bool = True
    sgr_complexity: SGRComplexityLevel = SGRComplexityLevel.Full
    segmentation: SegmentationLevel = SegmentationLevel.Full
    partition: PartitionSpeedSettings = field(default_factory=PartitionSpeedSettings)
    transform: TransformSpeedSettings = field(default_factory=TransformSpeedSettings)
    prediction: PredictionSpeedSettings = field(default_factory=PredictionSpeedSettings)
    motion: MotionSpeedSettings = field(default_factory=MotionSpeedSettings)

    @classmethod
    def from_preset(cls, speed: int) -> "SpeedSettings":
        """Speed presets 0 (slowest/best) .. 10 (fastest). >10 behaves as 10."""
        s = cls()
        if speed >= 1:
            s.lru_on_skip = False
            s.segmentation = SegmentationLevel.Simple
        if speed >= 2:
            s.partition.non_square_partition_max_threshold_log2 = 3  # 8x8
            s.prediction.prediction_modes = PredictionModesSetting.ComplexKeyframes
            s.motion.me_method = 2  # uneven multi-hex
        if speed >= 3:
            s.rdo_lookahead_frames = 30
            s.partition.partition_range = PartitionRange(3, 6)  # 8x8..64x64
        if speed >= 4:
            s.partition.encode_bottomup = False
            s.motion.me_method = 1  # hexagon
        if speed >= 5:
            s.sgr_complexity = SGRComplexityLevel.Reduced
            s.motion.include_near_mvs = False
            s.transform.full_tx_type_search = False
            s.joint_loop_rdo = False
        if speed >= 6:
            s.rdo_lookahead_frames = 20
            s.transform.rdo_tx_decision = False
            s.transform.reduced_tx_set = True
            s.motion.me_allow_full_search = False
            s.device_analysis = True
            s.device_chain = True
        if speed >= 7:
            s.prediction.prediction_modes = PredictionModesSetting.Simple
            s.multiref = False
            s.fast_deblock = True
            s.motion.me_method = 0  # diamond only
        if speed >= 8:
            s.rdo_lookahead_frames = 10
            s.lrf = False
        if speed >= 9:
            s.partition.partition_range = PartitionRange(4, 5)  # 16x16..32x32
            s.transform.enable_inter_tx_split = True
        if speed >= 10:
            s.temporal_rdo = False
            s.scene_detection_mode = SceneDetectionSpeed.Fast
            s.partition.partition_range = PartitionRange(5, 5)  # 32x32 only
            s.motion.use_satd_subpel = False
        return s
