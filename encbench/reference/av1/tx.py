"""Transform sizes, types and sets (reference: ``src/transform/mod.rs``).

TxSize enum order matches the AV1 spec / reference so that per-size tables
(intermediate shifts, tx scale) index directly.
"""

from __future__ import annotations

from enum import IntEnum


class TxSize(IntEnum):
    TX_4X4 = 0
    TX_8X8 = 1
    TX_16X16 = 2
    TX_32X32 = 3
    TX_64X64 = 4
    TX_4X8 = 5
    TX_8X4 = 6
    TX_8X16 = 7
    TX_16X8 = 8
    TX_16X32 = 9
    TX_32X16 = 10
    TX_32X64 = 11
    TX_64X32 = 12
    TX_4X16 = 13
    TX_16X4 = 14
    TX_8X32 = 15
    TX_32X8 = 16
    TX_16X64 = 17
    TX_64X16 = 18

    @property
    def width(self) -> int:
        return _TX_DIMS[self][0]

    @property
    def height(self) -> int:
        return _TX_DIMS[self][1]

    @property
    def width_log2(self) -> int:
        return _TX_DIMS[self][0].bit_length() - 1

    @property
    def height_log2(self) -> int:
        return _TX_DIMS[self][1].bit_length() - 1

    @property
    def area(self) -> int:
        return self.width * self.height

    @property
    def width_index(self) -> int:
        return self.width_log2 - 2

    @property
    def height_index(self) -> int:
        return self.height_log2 - 2

    def rect_ratio_log2(self) -> int:
        return self.width_log2 - self.height_log2

    def is_rect(self) -> bool:
        return abs(self.rect_ratio_log2()) == 1

    def sqr(self) -> "TxSize":
        """Largest square size <= this (used for context derivation)."""
        n = min(self.width_log2, self.height_log2)
        return [TxSize.TX_4X4, TxSize.TX_8X8, TxSize.TX_16X16, TxSize.TX_32X32, TxSize.TX_64X64][n - 2]

    def sqr_up(self) -> "TxSize":
        n = max(self.width_log2, self.height_log2)
        return [TxSize.TX_4X4, TxSize.TX_8X8, TxSize.TX_16X16, TxSize.TX_32X32, TxSize.TX_64X64][n - 2]

    @classmethod
    def by_dims(cls, w: int, h: int) -> "TxSize":
        return _BY_DIMS[(w, h)]


_TX_DIMS = {
    TxSize.TX_4X4: (4, 4),
    TxSize.TX_8X8: (8, 8),
    TxSize.TX_16X16: (16, 16),
    TxSize.TX_32X32: (32, 32),
    TxSize.TX_64X64: (64, 64),
    TxSize.TX_4X8: (4, 8),
    TxSize.TX_8X4: (8, 4),
    TxSize.TX_8X16: (8, 16),
    TxSize.TX_16X8: (16, 8),
    TxSize.TX_16X32: (16, 32),
    TxSize.TX_32X16: (32, 16),
    TxSize.TX_32X64: (32, 64),
    TxSize.TX_64X32: (64, 32),
    TxSize.TX_4X16: (4, 16),
    TxSize.TX_16X4: (16, 4),
    TxSize.TX_8X32: (8, 32),
    TxSize.TX_32X8: (32, 8),
    TxSize.TX_16X64: (16, 64),
    TxSize.TX_64X16: (64, 16),
}
_BY_DIMS = {v: k for k, v in _TX_DIMS.items()}

# From the AV1 spec 2D inverse transform process (row->col intermediate
# shift), indexed by TxSize (reference: inverse.rs INV_INTERMEDIATE_SHIFTS).
INV_INTERMEDIATE_SHIFTS = [0, 1, 2, 2, 2, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2]


def get_log_tx_scale(tx_size: TxSize) -> int:
    """Coefficient down-scaling for big transforms (quantize/mod.rs:30)."""
    a = tx_size.area
    return int(a > 256) + int(a > 1024)


class TxType(IntEnum):
    """2-D transform type (spec order; reference transform/mod.rs)."""

    DCT_DCT = 0
    ADST_DCT = 1
    DCT_ADST = 2
    ADST_ADST = 3
    FLIPADST_DCT = 4
    DCT_FLIPADST = 5
    FLIPADST_FLIPADST = 6
    ADST_FLIPADST = 7
    FLIPADST_ADST = 8
    IDTX = 9
    V_DCT = 10
    H_DCT = 11
    V_ADST = 12
    H_ADST = 13
    V_FLIPADST = 14
    H_FLIPADST = 15
    WHT_WHT = 16


class TxType1D(IntEnum):
    DCT = 0
    ADST = 1
    FLIPADST = 2
    IDTX = 3
    WHT = 4


# (vertical/column 1-D type, horizontal/row 1-D type)
_TX_1D = {
    TxType.DCT_DCT: (TxType1D.DCT, TxType1D.DCT),
    TxType.ADST_DCT: (TxType1D.ADST, TxType1D.DCT),
    TxType.DCT_ADST: (TxType1D.DCT, TxType1D.ADST),
    TxType.ADST_ADST: (TxType1D.ADST, TxType1D.ADST),
    TxType.FLIPADST_DCT: (TxType1D.FLIPADST, TxType1D.DCT),
    TxType.DCT_FLIPADST: (TxType1D.DCT, TxType1D.FLIPADST),
    TxType.FLIPADST_FLIPADST: (TxType1D.FLIPADST, TxType1D.FLIPADST),
    TxType.ADST_FLIPADST: (TxType1D.ADST, TxType1D.FLIPADST),
    TxType.FLIPADST_ADST: (TxType1D.FLIPADST, TxType1D.ADST),
    TxType.IDTX: (TxType1D.IDTX, TxType1D.IDTX),
    TxType.V_DCT: (TxType1D.DCT, TxType1D.IDTX),
    TxType.H_DCT: (TxType1D.IDTX, TxType1D.DCT),
    TxType.V_ADST: (TxType1D.ADST, TxType1D.IDTX),
    TxType.H_ADST: (TxType1D.IDTX, TxType1D.ADST),
    TxType.V_FLIPADST: (TxType1D.FLIPADST, TxType1D.IDTX),
    TxType.H_FLIPADST: (TxType1D.IDTX, TxType1D.FLIPADST),
    TxType.WHT_WHT: (TxType1D.WHT, TxType1D.WHT),
}


def get_1d_tx_types(tx_type: TxType):
    """Returns (col/vertical, row/horizontal) 1-D transform types."""
    return _TX_1D[tx_type]


class TxSet(IntEnum):
    """Which TxTypes may be signaled (spec 5.11.47 get_tx_set)."""

    TX_SET_DCTONLY = 0
    TX_SET_DCT_IDTX = 1  # inter 3
    TX_SET_DTT4_IDTX = 2  # intra 2
    TX_SET_DTT4_IDTX_1DDCT = 3  # intra 1
    TX_SET_DTT9_IDTX_1DDCT = 4  # inter 2
    TX_SET_ALL16 = 5  # inter 1


TX_SET_MEMBERS = {
    TxSet.TX_SET_DCTONLY: [TxType.DCT_DCT],
    TxSet.TX_SET_DCT_IDTX: [TxType.DCT_DCT, TxType.IDTX],
    TxSet.TX_SET_DTT4_IDTX: [
        TxType.DCT_DCT, TxType.ADST_DCT, TxType.DCT_ADST, TxType.ADST_ADST, TxType.IDTX
    ],
    TxSet.TX_SET_DTT4_IDTX_1DDCT: [
        TxType.DCT_DCT, TxType.ADST_DCT, TxType.DCT_ADST, TxType.ADST_ADST,
        TxType.IDTX, TxType.V_DCT, TxType.H_DCT,
    ],
    TxSet.TX_SET_DTT9_IDTX_1DDCT: [
        TxType.DCT_DCT, TxType.ADST_DCT, TxType.DCT_ADST, TxType.ADST_ADST,
        TxType.FLIPADST_DCT, TxType.DCT_FLIPADST, TxType.FLIPADST_FLIPADST,
        TxType.ADST_FLIPADST, TxType.FLIPADST_ADST, TxType.IDTX, TxType.V_DCT,
        TxType.H_DCT,
    ],
    TxSet.TX_SET_ALL16: list(TxType)[:16],
}


def get_tx_set(tx_size: TxSize, is_inter: bool, use_reduced_set: bool) -> TxSet:
    """Spec 5.11.47 / reference transform/mod.rs:280 (get_tx_set)."""
    tx_size_sqr_up = tx_size.sqr_up()
    tx_size_sqr = tx_size.sqr()
    if tx_size_sqr_up.width > 32:
        return TxSet.TX_SET_DCTONLY
    if is_inter:
        if use_reduced_set or tx_size_sqr_up == TxSize.TX_32X32:
            return TxSet.TX_SET_DCT_IDTX
        if tx_size_sqr == TxSize.TX_16X16:
            return TxSet.TX_SET_DTT9_IDTX_1DDCT
        return TxSet.TX_SET_ALL16
    else:
        if tx_size_sqr_up == TxSize.TX_32X32:
            return TxSet.TX_SET_DCTONLY
        if use_reduced_set or tx_size_sqr == TxSize.TX_16X16:
            return TxSet.TX_SET_DTT4_IDTX
        return TxSet.TX_SET_DTT4_IDTX_1DDCT


def valid_av1_transform(tx_size: TxSize, tx_type: TxType) -> bool:
    """A (size, type) combo is codable if the type's 1-D transforms exist at
    the needed lengths (ADST exists only up to 16)."""
    vert, horiz = get_1d_tx_types(tx_type)
    for t, n in ((vert, tx_size.height), (horiz, tx_size.width)):
        if t in (TxType1D.ADST, TxType1D.FLIPADST) and n > 16:
            return False
        if t == TxType1D.WHT and n != 4:
            return False
        if t == TxType1D.IDTX and n > 32:
            return False
    return True
