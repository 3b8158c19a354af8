"""AV1-normative tile geometry.

Behavioral counterpart of the reference's ``TilingInfo::from_target_tiles``
(tiling/tiler.rs:53-155) — same spec constraints (Annex A rate limits,
4:2:2 even-width adjustment).  In the TPU build, tiles are the unit of
cross-chip sharding: each tile's symbol stream is independent, so tiles map
1:1 onto mesh shards with no entropy-state exchange.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from rav1e_tpu_torch.utils import align_power_of_two, align_power_of_two_and_shift, ceil_div

MAX_TILE_WIDTH = 4096
MAX_TILE_AREA = 4096 * 2304
MAX_TILE_COLS = 64
MAX_TILE_ROWS = 64
MAX_TILE_RATE = 4096.0 * 2176.0 * 60.0 * 1.1


def tile_log2(blk_size: int, target: int) -> int:
    """Smallest k such that blk_size << k >= target (spec function)."""
    k = 0
    while (blk_size << k) < target:
        k += 1
    return k


@dataclass
class TilingInfo:
    frame_width: int
    frame_height: int
    tile_width_sb: int
    tile_height_sb: int
    cols: int
    rows: int
    tile_cols_log2: int
    tile_rows_log2: int
    min_tile_cols_log2: int
    max_tile_cols_log2: int
    min_tile_rows_log2: int
    max_tile_rows_log2: int
    sb_size_log2: int
    min_tiles_log2: int

    @property
    def tile_count(self) -> int:
        return self.cols * self.rows

    @classmethod
    def from_target_tiles(
        cls,
        sb_size_log2: int,
        frame_width: int,
        frame_height: int,
        frame_rate: float,
        tile_cols_log2: int,
        tile_rows_log2: int,
        is_422: bool,
    ) -> "TilingInfo":
        frame_width = align_power_of_two(frame_width, 3)
        frame_height = align_power_of_two(frame_height, 3)
        sb_cols = align_power_of_two_and_shift(frame_width, sb_size_log2)
        sb_rows = align_power_of_two_and_shift(frame_height, sb_size_log2)

        max_tile_width_sb = MAX_TILE_WIDTH >> sb_size_log2
        max_tile_area_sb = MAX_TILE_AREA >> (2 * sb_size_log2)
        min_tile_cols_log2 = tile_log2(max_tile_width_sb, sb_cols)
        max_tile_cols_log2 = tile_log2(1, min(sb_cols, MAX_TILE_COLS))
        max_tile_rows_log2 = tile_log2(1, min(sb_rows, MAX_TILE_ROWS))
        min_tiles_log2 = max(
            min_tile_cols_log2, tile_log2(max_tile_area_sb, sb_cols * sb_rows)
        )
        min_tiles_ratelimit_log2 = max(
            min_tiles_log2,
            math.ceil(
                math.log2(
                    max(
                        math.ceil(frame_width * frame_height * frame_rate / MAX_TILE_RATE),
                        1,
                    )
                )
            ),
        )

        tile_cols_log2 = min(max(tile_cols_log2, min_tile_cols_log2), max_tile_cols_log2)
        tile_width_sb_pre = align_power_of_two_and_shift(sb_cols, tile_cols_log2)
        tile_width_sb = ((tile_width_sb_pre + 1) >> 1 << 1) if is_422 else tile_width_sb_pre
        cols = ceil_div(sb_cols, tile_width_sb)
        tile_cols_log2 = tile_log2(1, cols)
        assert tile_cols_log2 >= min_tile_cols_log2

        min_tile_rows_log2 = max(min_tiles_log2 - tile_cols_log2, 0)
        min_tile_rows_ratelimit_log2 = max(min_tiles_ratelimit_log2 - tile_cols_log2, 0)
        tile_rows_log2 = min(
            max(max(tile_rows_log2, min_tile_rows_log2), min_tile_rows_ratelimit_log2),
            max_tile_rows_log2,
        )
        tile_height_sb = align_power_of_two_and_shift(sb_rows, tile_rows_log2)
        rows = ceil_div(sb_rows, tile_height_sb)

        return cls(
            frame_width=frame_width,
            frame_height=frame_height,
            tile_width_sb=tile_width_sb,
            tile_height_sb=tile_height_sb,
            cols=cols,
            rows=rows,
            tile_cols_log2=tile_cols_log2,
            tile_rows_log2=tile_rows_log2,
            min_tile_cols_log2=min_tile_cols_log2,
            max_tile_cols_log2=max_tile_cols_log2,
            min_tile_rows_log2=min_tile_rows_log2,
            max_tile_rows_log2=max_tile_rows_log2,
            sb_size_log2=sb_size_log2,
            min_tiles_log2=min_tiles_log2,
        )

    def tile_rect_mi(self, tile_col: int, tile_row: int, mi_cols: int, mi_rows: int):
        """(mi_x, mi_y, mi_w, mi_h) of one tile, clipped to the frame."""
        sb_mi = 1 << (self.sb_size_log2 - 2)
        x = tile_col * self.tile_width_sb * sb_mi
        y = tile_row * self.tile_height_sb * sb_mi
        w = min(self.tile_width_sb * sb_mi, mi_cols - x)
        h = min(self.tile_height_sb * sb_mi, mi_rows - y)
        return x, y, w, h
