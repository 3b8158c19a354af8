"""Film grain synthesis parameters (passthrough to the bitstream).

Counterpart of the reference's ``GrainTableSegment`` / film-grain config
(reference ``src/api/config/encoder.rs`` film_grain fields and
``header.rs:839-935`` syntax).  Synthesis itself is a decoder display-side
operation (spec 7.18.3); the encoder's job is carrying the parameters.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple


@dataclass
class GrainParams:
    """AV1 film_grain_params (spec 5.9.30)."""

    random_seed: int = 0
    scaling_points_y: List[Tuple[int, int]] = field(default_factory=list)
    scaling_points_cb: List[Tuple[int, int]] = field(default_factory=list)
    scaling_points_cr: List[Tuple[int, int]] = field(default_factory=list)
    chroma_scaling_from_luma: bool = False
    scaling_shift: int = 8          # 8..11
    ar_coeff_lag: int = 0           # 0..3
    ar_coeffs_y: List[int] = field(default_factory=list)   # -128..127
    ar_coeffs_cb: List[int] = field(default_factory=list)
    ar_coeffs_cr: List[int] = field(default_factory=list)
    ar_coeff_shift: int = 6         # 6..9
    grain_scale_shift: int = 0      # 0..3
    cb_mult: int = 0
    cb_luma_mult: int = 0
    cb_offset: int = 0
    cr_mult: int = 0
    cr_luma_mult: int = 0
    cr_offset: int = 0
    overlap_flag: bool = True

    @classmethod
    def photon_noise(cls, iso: int = 400, seed: int = 1) -> "GrainParams":
        """Simple luma-only noise table (capability analog of the reference's
        photon-noise table generation): flat scaling proportional to ISO."""
        strength = max(1, min(iso // 100, 64))
        return cls(
            random_seed=seed,
            scaling_points_y=[(0, strength), (255, strength)],
            scaling_shift=8,
            ar_coeff_lag=0,
            ar_coeff_shift=6,
            overlap_flag=True,
        )
