"""Block sizes, partition types, prediction modes.

Behavioral counterpart of the reference's ``src/partition.rs`` (BlockSize,
PartitionType) and ``src/predict.rs`` (PredictionMode).  Enum orders are the
AV1 spec's — they index CDFs and are coded directly.
"""

from __future__ import annotations

from enum import IntEnum

MI_SIZE_LOG2 = 2
MI_SIZE = 4


class BlockSize(IntEnum):
    BLOCK_4X4 = 0
    BLOCK_4X8 = 1
    BLOCK_8X4 = 2
    BLOCK_8X8 = 3
    BLOCK_8X16 = 4
    BLOCK_16X8 = 5
    BLOCK_16X16 = 6
    BLOCK_16X32 = 7
    BLOCK_32X16 = 8
    BLOCK_32X32 = 9
    BLOCK_32X64 = 10
    BLOCK_64X32 = 11
    BLOCK_64X64 = 12
    BLOCK_64X128 = 13
    BLOCK_128X64 = 14
    BLOCK_128X128 = 15
    BLOCK_4X16 = 16
    BLOCK_16X4 = 17
    BLOCK_8X32 = 18
    BLOCK_32X8 = 19
    BLOCK_16X64 = 20
    BLOCK_64X16 = 21

    @property
    def width(self) -> int:
        return _BS_DIMS[self][0]

    @property
    def height(self) -> int:
        return _BS_DIMS[self][1]

    @property
    def width_log2(self) -> int:
        return self.width.bit_length() - 1

    @property
    def height_log2(self) -> int:
        return self.height.bit_length() - 1

    @property
    def width_mi(self) -> int:
        return self.width >> MI_SIZE_LOG2

    @property
    def height_mi(self) -> int:
        return self.height >> MI_SIZE_LOG2

    def is_sqr(self) -> bool:
        return self.width == self.height

    def is_rect_lt_8x8(self) -> bool:
        return self in (BlockSize.BLOCK_4X8, BlockSize.BLOCK_8X4)

    @classmethod
    def from_wh(cls, w: int, h: int) -> "BlockSize":
        return _BS_BY_DIMS[(w, h)]

    def subsize(self, partition: "PartitionType"):
        """Child block size for a partition type (None if invalid)."""
        return _SUBSIZE_TABLE.get((partition, self))

    def largest_tx_size(self):
        """Largest TxSize for this block (spec Max_Tx_Size_Rect lookup):
        same aspect ratio (clamped to 2:1) with dims clamped to 64."""
        from encbench.reference.av1.tx import TxSize

        w = min(self.width, 64)
        h = min(self.height, 64)
        # clamp aspect ratio to the 2:1 the tx sizes support... 4:1 exists too
        return TxSize.by_dims(w, h)

    def chroma_block_size(self, xdec: int, ydec: int) -> "BlockSize":
        """Block size covering this block's chroma samples; extreme aspect
        ratios clamp to the nearest legal size (AOM ss_size_lookup behavior,
        e.g. 8x32 in 4:2:2 -> 4x16)."""
        w = max(self.width >> xdec, 4)
        h = max(self.height >> ydec, 4)
        while (w, h) not in _BS_BY_DIMS:
            if h > w:
                h //= 2
            else:
                w //= 2
        return BlockSize.from_wh(w, h)


_BS_DIMS = {
    BlockSize.BLOCK_4X4: (4, 4),
    BlockSize.BLOCK_4X8: (4, 8),
    BlockSize.BLOCK_8X4: (8, 4),
    BlockSize.BLOCK_8X8: (8, 8),
    BlockSize.BLOCK_8X16: (8, 16),
    BlockSize.BLOCK_16X8: (16, 8),
    BlockSize.BLOCK_16X16: (16, 16),
    BlockSize.BLOCK_16X32: (16, 32),
    BlockSize.BLOCK_32X16: (32, 16),
    BlockSize.BLOCK_32X32: (32, 32),
    BlockSize.BLOCK_32X64: (32, 64),
    BlockSize.BLOCK_64X32: (64, 32),
    BlockSize.BLOCK_64X64: (64, 64),
    BlockSize.BLOCK_64X128: (64, 128),
    BlockSize.BLOCK_128X64: (128, 64),
    BlockSize.BLOCK_128X128: (128, 128),
    BlockSize.BLOCK_4X16: (4, 16),
    BlockSize.BLOCK_16X4: (16, 4),
    BlockSize.BLOCK_8X32: (8, 32),
    BlockSize.BLOCK_32X8: (32, 8),
    BlockSize.BLOCK_16X64: (16, 64),
    BlockSize.BLOCK_64X16: (64, 16),
}
_BS_BY_DIMS = {v: k for k, v in _BS_DIMS.items()}


class PartitionType(IntEnum):
    PARTITION_NONE = 0
    PARTITION_HORZ = 1
    PARTITION_VERT = 2
    PARTITION_SPLIT = 3
    PARTITION_HORZ_A = 4  # HORZ split and top half is split again
    PARTITION_HORZ_B = 5
    PARTITION_VERT_A = 6
    PARTITION_VERT_B = 7
    PARTITION_HORZ_4 = 8
    PARTITION_VERT_4 = 9


def _build_subsize_table():
    t = {}
    for bs in BlockSize:
        w, h = bs.width, bs.height
        t[(PartitionType.PARTITION_NONE, bs)] = bs
        if (w // 2, h // 2) in _BS_BY_DIMS and w >= 8 and h >= 8:
            t[(PartitionType.PARTITION_SPLIT, bs)] = _BS_BY_DIMS[(w // 2, h // 2)]
        if (w, h // 2) in _BS_BY_DIMS:
            t[(PartitionType.PARTITION_HORZ, bs)] = _BS_BY_DIMS[(w, h // 2)]
        if (w // 2, h) in _BS_BY_DIMS:
            t[(PartitionType.PARTITION_VERT, bs)] = _BS_BY_DIMS[(w // 2, h)]
        if (w, h // 4) in _BS_BY_DIMS:
            t[(PartitionType.PARTITION_HORZ_4, bs)] = _BS_BY_DIMS[(w, h // 4)]
        if (w // 4, h) in _BS_BY_DIMS:
            t[(PartitionType.PARTITION_VERT_4, bs)] = _BS_BY_DIMS[(w // 4, h)]
        # A/B types use the same half sizes as HORZ/VERT plus quarter splits
        if (w, h // 2) in _BS_BY_DIMS and (w // 2, h // 2) in _BS_BY_DIMS:
            t[(PartitionType.PARTITION_HORZ_A, bs)] = _BS_BY_DIMS[(w, h // 2)]
            t[(PartitionType.PARTITION_HORZ_B, bs)] = _BS_BY_DIMS[(w, h // 2)]
        if (w // 2, h) in _BS_BY_DIMS and (w // 2, h // 2) in _BS_BY_DIMS:
            t[(PartitionType.PARTITION_VERT_A, bs)] = _BS_BY_DIMS[(w // 2, h)]
            t[(PartitionType.PARTITION_VERT_B, bs)] = _BS_BY_DIMS[(w // 2, h)]
    return t


_SUBSIZE_TABLE = _build_subsize_table()


def partition_children(x: int, y: int, bsize: BlockSize, partition: "PartitionType"):
    """Child blocks of a partition in coding order: [(cx, cy, csize)].

    Covers all 10 partition types (reference get_sub_partitions,
    rdo.rs:1825 + encoder.rs encode_partition_topdown AB/4 arms).  Callers
    skip children outside the tile (cx >= mi_w or cy >= mi_h).
    """
    half_h = bsize.subsize(PartitionType.PARTITION_HORZ)
    half_v = bsize.subsize(PartitionType.PARTITION_VERT)
    quarter = bsize.subsize(PartitionType.PARTITION_SPLIT)
    hw = bsize.width_mi // 2
    hh = bsize.height_mi // 2
    P = PartitionType
    if partition == P.PARTITION_NONE:
        return [(x, y, bsize)]
    if partition == P.PARTITION_HORZ:
        return [(x, y, half_h), (x, y + hh, half_h)]
    if partition == P.PARTITION_VERT:
        return [(x, y, half_v), (x + hw, y, half_v)]
    if partition == P.PARTITION_HORZ_A:
        return [(x, y, quarter), (x + hw, y, quarter), (x, y + hh, half_h)]
    if partition == P.PARTITION_HORZ_B:
        return [(x, y, half_h), (x, y + hh, quarter), (x + hw, y + hh, quarter)]
    if partition == P.PARTITION_VERT_A:
        return [(x, y, quarter), (x, y + hh, quarter), (x + hw, y, half_v)]
    if partition == P.PARTITION_VERT_B:
        return [(x, y, half_v), (x + hw, y, quarter), (x + hw, y + hh, quarter)]
    if partition == P.PARTITION_HORZ_4:
        s = bsize.subsize(P.PARTITION_HORZ_4)
        qh = bsize.height_mi // 4
        return [(x, y + k * qh, s) for k in range(4)]
    if partition == P.PARTITION_VERT_4:
        s = bsize.subsize(P.PARTITION_VERT_4)
        qw = bsize.width_mi // 4
        return [(x + k * qw, y, s) for k in range(4)]
    raise ValueError(f"not a leaf partition: {partition}")


def ext_partition_allowed(bsize: BlockSize) -> bool:
    """AB partitions need the 10-symbol partition CDF (>= 16x16 square)."""
    return bsize.is_sqr() and bsize.width >= 16 and bsize.width <= 64


def partition_4_allowed(bsize: BlockSize) -> bool:
    """HORZ_4/VERT_4 need a w x h/4 subsize (16x16..64x64 squares)."""
    return (
        bsize.is_sqr()
        and bsize.width >= 16
        and bsize.width <= 64
        and bsize.subsize(PartitionType.PARTITION_HORZ_4) is not None
    )


class PredictionMode(IntEnum):
    """Spec order: intra modes 0..12, CFL, then inter modes."""

    DC_PRED = 0
    V_PRED = 1
    H_PRED = 2
    D45_PRED = 3
    D135_PRED = 4
    D113_PRED = 5
    D157_PRED = 6
    D203_PRED = 7
    D67_PRED = 8
    SMOOTH_PRED = 9
    SMOOTH_V_PRED = 10
    SMOOTH_H_PRED = 11
    PAETH_PRED = 12
    UV_CFL_PRED = 13
    NEARESTMV = 14
    NEAR0MV = 15
    NEAR1MV = 16
    NEAR2MV = 17
    GLOBALMV = 18
    NEWMV = 19
    # compound
    NEAREST_NEARESTMV = 20
    NEAR_NEAR0MV = 21
    NEAR_NEAR1MV = 22
    NEAR_NEAR2MV = 23
    NEAREST_NEWMV = 24
    NEW_NEARESTMV = 25
    NEAR_NEW0MV = 26
    NEAR_NEW1MV = 27
    NEAR_NEW2MV = 28
    NEW_NEAR0MV = 29
    NEW_NEAR1MV = 30
    NEW_NEAR2MV = 31
    GLOBAL_GLOBALMV = 32
    NEW_NEWMV = 33

    def is_intra(self) -> bool:
        return self < PredictionMode.NEARESTMV

    def is_directional(self) -> bool:
        return PredictionMode.V_PRED <= self <= PredictionMode.D67_PRED

    def is_cfl(self) -> bool:
        return self == PredictionMode.UV_CFL_PRED

    def angle_delta_count(self) -> int:
        return 7 if self.is_directional() else 1


INTRA_MODES = 13
UV_INTRA_MODES = 14

# nominal angle per directional mode (reference predict.rs:138)
ANGLE_STEP = 3
MODE_TO_ANGLE = {
    PredictionMode.V_PRED: 90,
    PredictionMode.H_PRED: 180,
    PredictionMode.D45_PRED: 45,
    PredictionMode.D135_PRED: 135,
    PredictionMode.D113_PRED: 113,
    PredictionMode.D157_PRED: 157,
    PredictionMode.D203_PRED: 203,
    PredictionMode.D67_PRED: 67,
}


def intra_mode_to_angle(mode: PredictionMode) -> int:
    return MODE_TO_ANGLE.get(mode, 0)


def supersample_chroma_bsize(bsize: BlockSize, ss_x: int, ss_y: int) -> BlockSize:
    """Scale small chroma prediction block sizes up to legal sizes
    (reference partition.rs:559-598)."""
    w, h = bsize.width, bsize.height
    if w < 8 and ss_x:
        w *= 2
    if h < 8 and ss_y:
        h *= 2
    # clamp to existing sizes
    while (w, h) not in _BS_BY_DIMS:
        if w < h:
            w *= 2
        else:
            h *= 2
    return _BS_BY_DIMS[(w, h)]
