"""Inter-frame pyramid configuration and GOP planning.

Capability counterpart of the reference's ``InterConfig``
(``api/internal.rs:41-204``) and the slot/ref derivation in
``FrameInvariants::new_inter_frame`` (``encoder.rs:990-1100``): a depth-2
re-ordering pyramid (group of 4 inputs / 6 outputs with two hidden frames
and two show-existing-frame outputs), level-0 reference slots cycling
0..3 and per-level slots 4/5.

Partial groups (ahead of a keyframe or at end of stream) fall back to
low-latency P frames — simpler than the reference's truncated-group
arithmetic, same bitstream legality.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


def pos_to_lvl(pos: int, pyramid_depth: int) -> int:
    """Pyramid level from coding position (encoder.rs:817-827)."""
    v = pos | (1 << pyramid_depth)
    tz = (v & -v).bit_length() - 1
    return pyramid_depth - tz


@dataclass
class PlannedFrame:
    kind: str                     # "key" | "inter" | "sef"
    input_frameno: int
    switch: bool = False          # encode as an S-frame (spec 6.8.2)
    order_hint: int = 0           # relative to GOP start
    level: int = 0
    show_frame: bool = True
    slot: int = 0                 # slot this frame refreshes / SEF shows
    ref_slot_fwd: int = 0
    ref_slot_bwd: Optional[int] = None
    # far backward anchor (a second future reference beyond ref_slot_bwd),
    # searched as single-prediction BWDREF (reference rdo.rs:1138-1155
    # multi-ref loop); None when no distinct far anchor exists
    ref_slot_bwd2: Optional[int] = None
    ref_frames: List[int] = field(default_factory=lambda: [0] * 7)
    # temporal-RDO grids (internal.rs:912-1259): per-8x8 propagated
    # importance and the frame's own intra-cost grid, filled by the
    # scheduler's lookahead pass for pyramid anchors
    importances: object = None
    la_intra: object = None


class InterConfig:
    """Reordering group geometry (api/internal.rs:60-91)."""

    def __init__(self, low_latency: bool):
        self.reorder = not low_latency
        self.pyramid_depth = 2 if self.reorder else 0
        self.group_input_len = 1 << self.pyramid_depth
        self.group_output_len = self.group_input_len + self.pyramid_depth

    def keyframe_lookahead_distance(self) -> int:
        return self.group_input_len + 1

    # slot a frame of (level, order_hint) is stored into (internal.rs:146-155)
    def slot_of(self, order_hint: int) -> int:
        lvl = pos_to_lvl(order_hint, self.pyramid_depth)
        if lvl == 0:
            return (order_hint >> self.pyramid_depth) & 3
        return 3 + lvl

    def plan_group(self, s: int, gop_start: int) -> List[PlannedFrame]:
        """Coding-order plan for the pyramid group over inputs [s, s+3]
        (internal.rs:63-77 example layout)."""
        d = self.pyramid_depth
        gil = self.group_input_len
        oh = lambda f: f - gop_start

        def mk(f: int, level: int, show: bool) -> PlannedFrame:
            o = oh(f)
            slot = self.slot_of(o) if level == pos_to_lvl(o, d) else 3 + level
            if level == 0:
                fwd = (slot + 4 - 1) % 4
                bwd = None
                bwd2 = None
            else:
                fwd = self.slot_of(o - (gil >> level))
                bwd = self.slot_of(o + (gil >> level))
                # far anchor two pyramid hops out (only the first level-2
                # frame of a group has a future ref beyond its near anchor)
                bwd2 = None
                if level >= 2:
                    far = self.slot_of(o + (gil >> level) + (gil >> (level - 1)))
                    if far != bwd:
                        bwd2 = far
            refs = [fwd] * 7
            if bwd is not None:
                refs[6] = bwd  # ALTREF_FRAME index (encoder.rs:1079)
            if bwd2 is not None:
                refs[4] = bwd2  # BWDREF_FRAME carries the far anchor
            refs[2] = slot  # LAST3: previous frame in same level (encoder.rs:1091)
            return PlannedFrame(
                "inter", f, order_hint=o, level=level, show_frame=show,
                slot=slot, ref_slot_fwd=fwd, ref_slot_bwd=bwd,
                ref_slot_bwd2=bwd2, ref_frames=refs,
            )

        return [
            mk(s + 3, 0, False),
            mk(s + 1, 1, False),
            mk(s, 2, True),
            PlannedFrame("sef", s + 1, order_hint=oh(s + 1), slot=self.slot_of(oh(s + 1))),
            mk(s + 2, 2, True),
            PlannedFrame("sef", s + 3, order_hint=oh(s + 3), slot=self.slot_of(oh(s + 3))),
        ]

    def plan_p(self, f: int, gop_start: int, prev_slot: int, slot: int) -> PlannedFrame:
        """Low-latency P frame (partial group fallback / low_latency mode)."""
        refs = [prev_slot] * 7
        return PlannedFrame(
            "inter", f, order_hint=f - gop_start, level=0, show_frame=True,
            slot=slot, ref_slot_fwd=prev_slot, ref_slot_bwd=None, ref_frames=refs,
        )
