"""AV1 level constraints (spec Annex A; reference src/levels.rs).

Validates an encoder configuration against the selected ``level_idx`` (or
derives the minimal level when unset) — max picture size, dimensions, and
display rate per level.
"""

from __future__ import annotations

from typing import Optional

# level_idx -> (max_pic_size, max_h_size, max_v_size, max_display_rate)
# (spec Annex A.3 table; reference levels.rs)
LEVEL_LIMITS = {
    0: (147456, 2048, 1152, 4423680),        # 2.0
    1: (278784, 2816, 1584, 8363520),        # 2.1
    4: (665856, 4352, 2448, 19975680),       # 3.0
    5: (1065024, 5504, 3096, 31950720),      # 3.1
    8: (2359296, 6144, 3456, 70778880),      # 4.0
    9: (2359296, 6144, 3456, 141557760),     # 4.1
    12: (8912896, 8192, 4352, 267386880),    # 5.0
    13: (8912896, 8192, 4352, 534773760),    # 5.1
    14: (8912896, 8192, 4352, 1069547520),   # 5.2
    15: (8912896, 8192, 4352, 1069547520),   # 5.3
    16: (35651584, 16384, 8704, 1069547520),  # 6.0
    17: (35651584, 16384, 8704, 2139095040),  # 6.1
    18: (35651584, 16384, 8704, 4278190080),  # 6.2
    19: (35651584, 16384, 8704, 4278190080),  # 6.3
    31: (None, None, None, None),             # maximum parameters
}


def check_level(width: int, height: int, frame_rate: float,
                level_idx: Optional[int]) -> Optional[str]:
    """Returns an error string when the config exceeds the level, else None.

    level_idx None or 31 means "maximum parameters" (no constraint)."""
    if level_idx is None or level_idx == 31:
        return None
    if level_idx not in LEVEL_LIMITS:
        return f"unknown level_idx {level_idx}"
    max_pic, max_h, max_v, max_rate = LEVEL_LIMITS[level_idx]
    pic = width * height
    if pic > max_pic:
        return f"picture size {pic} exceeds level {level_idx} limit {max_pic}"
    if width > max_h:
        return f"width {width} exceeds level {level_idx} limit {max_h}"
    if height > max_v:
        return f"height {height} exceeds level {level_idx} limit {max_v}"
    if pic * frame_rate > max_rate:
        return (
            f"display rate {pic * frame_rate:.0f} exceeds level {level_idx} "
            f"limit {max_rate}"
        )
    return None


def minimal_level(width: int, height: int, frame_rate: float) -> int:
    """Smallest level_idx whose limits hold (31 when none do)."""
    for idx in sorted(k for k in LEVEL_LIMITS if k != 31):
        if check_level(width, height, frame_rate, idx) is None:
            return idx
    return 31
