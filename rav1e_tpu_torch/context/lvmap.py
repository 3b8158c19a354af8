"""Level-map coefficient coding helpers shared by encoder and decoder.

Spec-orientation versions of the context derivations in the reference's
``src/context/transform_unit.rs`` (which works on transposed coefficients;
see its comments at :784, :794, :857 — we keep spec layout, so row/col swap
back).  All functions operate on a zero-padded 2-D ``levels`` array of shape
``(coded_h + 4, coded_w + 4)`` holding ``min(abs(coeff), 127)``.
"""

from __future__ import annotations

import numpy as np

from rav1e_tpu_torch.tx import TxSize, TxType, TxType1D, get_1d_tx_types

TX_CLASS_2D = 0
TX_CLASS_HORIZ = 1  # horizontal-only 1-D tx (H_DCT...)
TX_CLASS_VERT = 2  # vertical-only 1-D tx (V_DCT...)

NUM_BASE_LEVELS = 2
BR_CDF_SIZE = 4
COEFF_BASE_RANGE = 4 * (BR_CDF_SIZE - 1)
MAX_BASE_BR_RANGE = COEFF_BASE_RANGE + NUM_BASE_LEVELS + 1

# eob position token tables (normative; transform_unit.rs:291-310)
EOB_TO_POS_SMALL = [0, 1, 2, 3, 3, 4, 4, 4, 4] + [5] * 8 + [6] * 16
EOB_TO_POS_LARGE = [6, 7, 8, 8, 9, 9, 9, 9] + [10] * 8 + [11]
K_EOB_GROUP_START = [0, 1, 2, 3, 5, 9, 17, 33, 65, 129, 257, 513]
K_EOB_OFFSET_BITS = [0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9]


def tx_class(tx_type: TxType) -> int:
    vert, horiz = get_1d_tx_types(tx_type)
    if vert == TxType1D.IDTX and horiz != TxType1D.IDTX:
        return TX_CLASS_HORIZ
    if horiz == TxType1D.IDTX and vert != TxType1D.IDTX:
        return TX_CLASS_VERT
    return TX_CLASS_2D


def coded_dims(tx_size: TxSize):
    """Coded (clamped to 32) dimensions."""
    return min(tx_size.width, 32), min(tx_size.height, 32)


def txsize_entropy_ctx(tx_size: TxSize) -> int:
    return (int(tx_size.sqr()) + int(tx_size.sqr_up()) + 1) >> 1


def get_eob_pos_token(eob: int):
    if eob < 33:
        t = EOB_TO_POS_SMALL[eob]
    else:
        t = EOB_TO_POS_LARGE[min((eob - 1) >> 5, 16)]
    return t, eob - K_EOB_GROUP_START[t]


def init_levels(qcoeffs: np.ndarray, coded_w: int, coded_h: int) -> np.ndarray:
    """Padded |level| array (coded_h+4, coded_w+4), uint8."""
    levels = np.zeros((coded_h + 4, coded_w + 4), dtype=np.uint8)
    levels[:coded_h, :coded_w] = np.minimum(
        np.abs(qcoeffs[:coded_h, :coded_w]), 127
    ).astype(np.uint8)
    return levels


def coeff_base_ctx(
    levels: np.ndarray, row: int, col: int, w: int, h: int, cls: int
) -> int:
    """Sig-map (coeff_base) context (spec; transform_unit.rs:821-907)."""
    if cls == TX_CLASS_2D and row == 0 and col == 0:
        return 0
    m = 0
    m += min(3, int(levels[row, col + 1]))
    m += min(3, int(levels[row + 1, col]))
    if cls == TX_CLASS_2D:
        m += min(3, int(levels[row + 1, col + 1]))
        m += min(3, int(levels[row, col + 2]))
        m += min(3, int(levels[row + 2, col]))
    elif cls == TX_CLASS_VERT:
        m += min(3, int(levels[row + 2, col]))
        m += min(3, int(levels[row + 3, col]))
        m += min(3, int(levels[row + 4, col]))
    else:  # HORIZ
        m += min(3, int(levels[row, col + 2]))
        m += min(3, int(levels[row, col + 3]))
        m += min(3, int(levels[row, col + 4]))
    ctx = min((m + 1) >> 1, 4)
    if cls == TX_CLASS_2D:
        # generation rule from transform_unit.rs:866-876 (spec table)
        if w < h and row < 2:
            return 11 + ctx
        if w > h and col < 2:
            return 16 + ctx
        if row + col < 2:
            return ctx + 1
        if row + col < 4:
            return 5 + ctx + 1
        return 21 + ctx
    if cls == TX_CLASS_HORIZ:
        pos = col
    else:
        pos = row
    return 26 + (0 if pos == 0 else (5 if pos == 1 else 10)) + ctx


def coeff_base_eob_ctx(scan_idx: int, eob: int, area: int) -> int:
    if scan_idx == 0:
        return 0
    if scan_idx <= area // 8:
        return 1
    if scan_idx <= area // 4:
        return 2
    return 3


def br_ctx(levels: np.ndarray, row: int, col: int, cls: int) -> int:
    """Coefficient base-range context (transform_unit.rs:938-985)."""
    m = int(levels[row, col + 1]) + int(levels[row + 1, col])
    if cls == TX_CLASS_2D:
        m += int(levels[row + 1, col + 1])
        m = min((m + 1) >> 1, 6)
        if row == 0 and col == 0:
            return m
        if row < 2 and col < 2:
            return m + 7
    elif cls == TX_CLASS_HORIZ:
        m += int(levels[row, col + 2])
        m = min((m + 1) >> 1, 6)
        if row == 0 and col == 0:
            return m
        if col == 0:
            return m + 7
    else:
        m += int(levels[row + 2, col])
        m = min((m + 1) >> 1, 6)
        if row == 0 and col == 0:
            return m
        if row == 0:
            return m + 7
    return m + 14
