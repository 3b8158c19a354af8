"""Public API utility types (reference: ``src/api/util.rs``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum, IntEnum
from typing import Optional


class EncoderStatus(Exception):
    """Raised by Context methods (reference: ``api/util.rs:155``).

    Python-idiomatic twist: where the reference returns ``Err(status)``,
    ``send_frame`` / ``receive_packet`` raise the corresponding subclass,
    reachable as ``EncoderStatus.NeedMoreData`` etc. for rav1e-style code.
    """


class NeedMoreData(EncoderStatus):
    """May not receive a packet until more frames are sent."""


class EnoughData(EncoderStatus):
    """May not send a frame until packets are received."""


class LimitReached(EncoderStatus):
    """The encoder has flushed and produced all packets."""


class Encoded(EncoderStatus):
    """A frame was encoded in this call, but no packet is ready yet."""


class Failure(EncoderStatus):
    """Generic fatal error."""


class NotReady(EncoderStatus):
    """First-pass data required before a frame can be encoded."""


EncoderStatus.NeedMoreData = NeedMoreData
EncoderStatus.EnoughData = EnoughData
EncoderStatus.LimitReached = LimitReached
EncoderStatus.Encoded = Encoded
EncoderStatus.Failure = Failure
EncoderStatus.NotReady = NotReady


class FrameType(IntEnum):
    """AV1 frame types (spec: frame_type syntax element)."""

    KEY = 0
    INTER = 1
    INTRA_ONLY = 2
    SWITCH = 3

    def has_inter(self) -> bool:
        return self in (FrameType.INTER, FrameType.SWITCH)

    def all_intra(self) -> bool:
        return self in (FrameType.KEY, FrameType.INTRA_ONLY)


class FrameTypeOverride(IntEnum):
    No = 0
    Key = 1


@dataclass
class EncoderStats:
    """Per-packet coding statistics (reference: ``src/stats.rs:21-33``)."""

    block_size_counts: dict = field(default_factory=dict)
    skip_block_count: int = 0
    tx_type_counts: dict = field(default_factory=dict)
    luma_pred_mode_counts: dict = field(default_factory=dict)
    chroma_pred_mode_counts: dict = field(default_factory=dict)

    def __iadd__(self, other: "EncoderStats"):
        for k, v in other.block_size_counts.items():
            self.block_size_counts[k] = self.block_size_counts.get(k, 0) + v
        for k, v in other.tx_type_counts.items():
            self.tx_type_counts[k] = self.tx_type_counts.get(k, 0) + v
        for k, v in other.luma_pred_mode_counts.items():
            self.luma_pred_mode_counts[k] = self.luma_pred_mode_counts.get(k, 0) + v
        for k, v in other.chroma_pred_mode_counts.items():
            self.chroma_pred_mode_counts[k] = self.chroma_pred_mode_counts.get(k, 0) + v
        self.skip_block_count += other.skip_block_count
        return self


@dataclass
class T35:
    """ITU-T T.35 metadata payload (reference: api/util.rs T35)."""

    country_code: int = 0xB5
    country_code_extension_byte: int = 0x00
    data: bytes = b""


@dataclass
class Packet:
    """One encoded frame (reference: ``api/util.rs:201-224``)."""

    data: bytes
    input_frameno: int
    frame_type: FrameType
    qp: int
    rec: Optional[object] = None  # reconstruction Frame (if requested)
    source: Optional[object] = None
    enc_stats: EncoderStats = field(default_factory=EncoderStats)
    opaque: object = None
    # whether this packet displays a frame (False for hidden pyramid frames
    # whose show-existing-frame packet arrives later)
    show_frame: bool = True

    def __repr__(self):
        return (
            f"Packet(frame={self.input_frameno}, type={self.frame_type.name}, "
            f"qp={self.qp}, {len(self.data)} bytes)"
        )
