"""Rate control.

Capability counterpart of the reference's ``src/rate.rs`` (libtheora-style
``RCState``: bitrate reservoir, per-frame-subtype rate models, two-pass
metrics packets).  Redesigned rather than ported: a log-domain exponential
rate model per frame subtype with a leaky bit reservoir — simpler state, the
same behaviors: CQ mode, 1-pass bitrate mode with reservoir smoothing, and
versioned two-pass data (chunk-compatible first pass).

The TPU angle (SURVEY §2.7): the only cross-chip input this needs is the
per-tile bit count sum, which arrives via the ICI psum in
rav1e_tpu/parallel; everything here is scalar host math.
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass, field
from typing import List, Optional

from rav1e_tpu_torch import tables
from rav1e_tpu_torch.api.util import FrameType

TWOPASS_MAGIC = 0x50325452  # "RT2P"
TWOPASS_VERSION = 1

# frame subtypes (reference rate.rs:23-31): KEY, P (level 0), B0, B1
FRAME_SUBTYPE_I = 0
FRAME_SUBTYPE_P = 1
FRAME_SUBTYPE_B0 = 2
FRAME_SUBTYPE_B1 = 3
FRAME_NSUBTYPES = 4


def _subtype(frame_type, level: int) -> int:
    if frame_type == FrameType.KEY:
        return FRAME_SUBTYPE_I
    if level <= 0:
        return FRAME_SUBTYPE_P
    return FRAME_SUBTYPE_B0 if level == 1 else FRAME_SUBTYPE_B1


@dataclass
class TwoPassFrameData:
    frame_type: int
    log_scale_q57: int  # complexity metric


@dataclass
class TwoPassSummary:
    total_frames: int = 0
    total_log_scale: int = 0
    ntus: int = 0


class IIRBessel2:
    """Second-order Bessel low-pass (reference rate.rs:122-215): smooths
    the per-subtype rate-model corrections so a single outlier frame can't
    swing the quantizer; delay is the -3dB point in frames."""

    __slots__ = ("c0", "c1", "g", "x0", "x1", "y0", "y1")

    def __init__(self, delay: float, value: float = 0.0):
        self.set_delay(delay)
        self.x0 = self.x1 = value
        self.y0 = self.y1 = value

    def set_delay(self, delay: float) -> None:
        # bilinear-transformed continuous-time Bessel poles
        # (theta scaled so `delay` frames reach ~63% of a step)
        import math as _m

        delay = max(delay, 1.0)
        theta = 2.0 * _m.pi / (4.0 * delay)
        d = 1.0 + 3.0 / (2.0 * theta) + 3.0 / (theta * theta) * 0.75
        self.c0 = (3.0 / theta + 1.5 / (theta * theta)) / d
        self.c1 = (-0.75 / (theta * theta)) / d
        self.g = 1.0 - self.c0 - self.c1

    def update(self, x: float) -> float:
        ya = self.c0 * self.y0 + self.c1 * self.y1 + self.g * x
        self.y1, self.y0 = self.y0, ya
        self.x1, self.x0 = self.x0, x
        return ya

    @property
    def value(self) -> float:
        return self.y0


class RCState:
    """Rate controller: CQ or bitrate mode with reservoir."""

    def __init__(
        self,
        bit_depth: int,
        quantizer: int,  # Q3 quantizer for CQ mode (reference semantics)
        bitrate: int,  # bits per second; 0 => CQ
        framerate: float,
        reservoir_frame_delay: Optional[int] = None,
        min_quantizer: int = 0,
        max_key_frame_interval: int = 240,
    ):
        self.bit_depth = bit_depth
        self.bitrate = bitrate
        self.framerate = max(framerate, 1e-6)
        self.min_quantizer = min_quantizer
        self.cq_mode = bitrate <= 0
        self.base_quantizer = quantizer

        self.bits_per_frame = bitrate / self.framerate if bitrate > 0 else 0.0
        delay = reservoir_frame_delay or max(min(int(self.framerate * 1.5), 600), 12)
        self.reservoir_frame_delay = delay
        self.reservoir_max = self.bits_per_frame * delay
        self.reservoir_fullness = self.reservoir_max * 0.5

        # log-domain rate models per subtype: log2(bits_per_px * 4096) ~
        # a - b*log2(q_step_q3); intercepts seeded from typical 8-bit content
        # and refit from the first observations
        self._model_a = [23.0, 21.5, 21.0, 20.5]
        self._model_b = [1.1, 1.3, 1.3, 1.3]
        self._model_n = [0, 0, 0, 0]
        # Bessel-smoothed intercept corrections (rate.rs IIRBessel2 usage):
        # I frames are rare -> short delay; B1 frames are frequent -> longer
        self._model_filt = [
            IIRBessel2(d) for d in (2.0, 4.0, 6.0, 8.0)
        ]

        # I-frame boost relative to P; B frames get reduced targets
        self.i_boost = 1.8
        self.b_discount = [1.0, 1.0, 0.7, 0.55]

        # two-pass
        self.twopass_record: List[TwoPassFrameData] = []
        self.pass1_data: Optional[List[TwoPassFrameData]] = None
        self.pass1_pos = 0

    # --- quantizer selection -------------------------------------------

    def select_qi(
        self, frame_type: FrameType, width: int, height: int, level: int = 0
    ) -> int:
        """Pick the base_q_idx for the next frame."""
        st = _subtype(frame_type, level)
        if self.cq_mode:
            # deeper pyramid levels quantize harder (reference rate.rs MQP)
            q_mult = [1.0, 1.0, 1.25, 1.4][st]
            qi = tables.select_ac_qi(
                max(int(round(self.base_quantizer * q_mult)), 1), self.bit_depth
            )
            return max(qi, 1)

        npx = width * height
        target = max(self._frame_target(st), 8.0 * npx / 1000.0)

        # invert the model: log2(q) = (a - log2(bits/px)) / b
        a, b = self._model_a[st], self._model_b[st]
        log_bpp = math.log2(max(target / npx, 1e-6))
        log_q = (a - (log_bpp + 12.0)) / max(b, 0.1)
        q_step3 = max(min(2.0 ** log_q, 7000.0), 4.0)  # Q3 quantizer
        qi = tables.select_ac_qi(int(round(q_step3)), self.bit_depth)
        qi = max(qi, self.min_quantizer, 1)
        return min(qi, 255)

    def _frame_target(self, st: int) -> float:
        """Per-frame bit target for a subtype — the single source of truth
        shared by select_qi and needs_trial_encode so the trial threshold
        measures against the same target the frame was encoded toward.

        Group-normalized subtype weights: the steady-state pyramid group
        (P, B0, B1, B1) must average to bits_per_frame, so the discounts
        redistribute within the group instead of shrinking the total."""
        wsum = (
            self.b_discount[FRAME_SUBTYPE_P]
            + self.b_discount[FRAME_SUBTYPE_B0]
            + 2.0 * self.b_discount[FRAME_SUBTYPE_B1]
        )
        target = self.bits_per_frame * 4.0 * self.b_discount[st] / wsum
        # reservoir correction: nudge toward half-full
        deviation = (self.reservoir_fullness - 0.5 * self.reservoir_max) / max(
            self.reservoir_max, 1.0
        )
        target *= max(1.0 + 1.2 * deviation, 0.1)
        if st == FRAME_SUBTYPE_I:
            target *= self.i_boost
        # two-pass: scale target by relative complexity
        if self.pass1_data is not None and self.pass1_pos < len(self.pass1_data):
            rec = self.pass1_data[self.pass1_pos]
            avg = max(
                sum(d.log_scale_q57 for d in self.pass1_data) / len(self.pass1_data), 1.0
            )
            target *= max(min(rec.log_scale_q57 / avg, 3.0), 0.33)
        return target

    # --- post-frame update ---------------------------------------------

    def update_state(
        self, bits_used: int, frame_type: FrameType, qindex: int, width: int,
        height: int, level: int = 0,
    ) -> None:
        st = _subtype(frame_type, level)
        npx = width * height
        q_step3 = tables.ac_q(qindex, 0, self.bit_depth)
        log_q = math.log2(max(q_step3, 1))
        log_bpp = math.log2(max(bits_used / npx, 1e-6)) + 12.0
        # refit intercept a with the observed point (slope fixed)
        a_obs = log_bpp + self._model_b[st] * log_q
        n = self._model_n[st]
        prev_a = self._model_a[st]
        if n < 3:
            # fast convergence on the first observations
            self._model_a[st] += (1.0 if n == 0 else 0.5) * (a_obs - prev_a)
            f = self._model_filt[st]
            f.x0 = f.x1 = f.y0 = f.y1 = self._model_a[st]
        else:
            # steady state: Bessel-filtered intercept (outlier-robust,
            # reference rate.rs IIRBessel2 scale smoothing)
            self._model_a[st] = self._model_filt[st].update(a_obs)
        self._model_n[st] = n + 1
        if n == 0:
            # share the first correction with unobserved sibling subtypes so
            # the first P/B frames benefit from the I frame's calibration
            delta = self._model_a[st] - prev_a
            for other in range(FRAME_NSUBTYPES):
                if other != st and self._model_n[other] == 0:
                    self._model_a[other] += delta

        if not self.cq_mode:
            self.reservoir_fullness += self.bits_per_frame - bits_used
            self.reservoir_fullness = max(
                min(self.reservoir_fullness, self.reservoir_max), -self.reservoir_max
            )

        # two-pass pass-1 recording: complexity = bits at this q, normalized
        scale = int(bits_used * q_step3 / 8)
        self.twopass_record.append(TwoPassFrameData(st, max(scale, 1)))
        if self.pass1_data is not None:
            self.pass1_pos += 1

    # --- trial encode (reference rate.rs needs_trial_encode:1234) ------

    def needs_trial_encode(self, bits_used: int, frame_type, level: int = 0) -> bool:
        """True when the first frame of a subtype missed its target badly
        enough that re-encoding at a corrected quantizer is worth the cost
        (bitrate mode only)."""
        if self.cq_mode or self.bits_per_frame <= 0:
            return False
        st = _subtype(frame_type, level)
        if self._model_n[st] > 0:
            return False
        ratio = bits_used / max(self._frame_target(st), 1.0)
        return ratio > 2.5 or ratio < 0.4

    def observe_trial(
        self, bits_used: int, frame_type, qindex: int, width: int, height: int,
        level: int = 0,
    ) -> None:
        """Fold a trial encode's outcome into the rate model without
        touching the reservoir or two-pass record."""
        st = _subtype(frame_type, level)
        npx = width * height
        q_step3 = tables.ac_q(qindex, 0, self.bit_depth)
        log_q = math.log2(max(q_step3, 1))
        a_obs = math.log2(max(bits_used / npx, 1e-6)) + 12.0 + self._model_b[st] * log_q
        self._model_a[st] = a_obs
        f = self._model_filt[st]
        f.x0 = f.x1 = f.y0 = f.y1 = a_obs
        self._model_n[st] = 1

    # --- two-pass data plumbing (reference rate.rs:1294-1446) ----------

    def twopass_out(self) -> Optional[bytes]:
        """Serialize first-pass data recorded so far (call after flush)."""
        if not self.twopass_record:
            return None
        out = bytearray(struct.pack("<III", TWOPASS_MAGIC, TWOPASS_VERSION, len(self.twopass_record)))
        for d in self.twopass_record:
            out += struct.pack("<Bq", d.frame_type, d.log_scale_q57)
        return bytes(out)

    def twopass_in(self, data: bytes) -> int:
        """Load first-pass data for the second pass. Returns frames loaded."""
        magic, version, count = struct.unpack_from("<III", data, 0)
        if magic != TWOPASS_MAGIC or version != TWOPASS_VERSION:
            raise ValueError("bad two-pass data")
        pos = 12
        frames = []
        for _ in range(count):
            ft, scale = struct.unpack_from("<Bq", data, pos)
            pos += struct.calcsize("<Bq")
            frames.append(TwoPassFrameData(ft, scale))
        self.pass1_data = frames
        self.pass1_pos = 0
        return count
