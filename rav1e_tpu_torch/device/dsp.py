"""Device recon-path DSP on PyTorch tensors: batched exact-integer motion
compensation, forward transform + quantize, dequantize + inverse transform,
and deblocking.

Counterpart of ``rav1e_tpu/device/dsp.py``.  Every function is bit-exact
integer math on int32 tensors, on the CPU or the card alike, and equals the
host oracles (``ops/mc.py``, ``quantize.py``, ``ops/transforms.py``,
``ops/deblock.py``) and the reference's device functions
(tests/test_torch_dsp.py).  Whole-frame batches of same-shaped blocks run as
one set of tensor operations; per-block variation (MV, subpel phase,
reference, quantizer) is handled by gathers, never by control flow.

A deblock pass (:func:`deblock_pass_device`) runs ``csrc/deblock.cu``'s
``deblock_edges`` on a card and :func:`deblock_pass_plain` on the CPU.

Left out: the reference's one-hot matrix-product gathers
(``gather_rows_onehot``, ``_cols_window``, ``_on_tpu``), which exist only
because its device serialises indexed loads; windows here are gathered by
plain advanced indexing.
"""

from __future__ import annotations

import numpy as np
import torch

from rav1e_tpu_torch.device import _build, kernels
from rav1e_tpu_torch.device.constants import device_cache
from rav1e_tpu_torch.ops.mc import SUBPEL_FILTERS
from rav1e_tpu_torch.ops.transforms import (
    FWD_MAT_SHIFT,
    _fwd_matrices_int,
    inverse_transform_add,
)
from rav1e_tpu_torch.tx import TxSize, TxType, get_log_tx_scale

_I32 = torch.int32


def _rs(x, bit: int):
    """round_shift on int32 (arithmetic shift, as native rshift12_32)."""
    if bit == 0:
        return x
    return (x + (1 << (bit - 1))) >> bit


# ---------------------------------------------------------------------------
# Motion compensation (exact; ops/mc.py put_8tap / prep_8tap / mc_avg)
# ---------------------------------------------------------------------------
#
# The host kernel has four rounding branches keyed on (col_frac==0,
# row_frac==0).  The general two-stage path with the phase-0 filter row
# ([0,0,0,128,0,...]) is bit-identical to every special branch (the pure
# shifts commute with the round-shifts and the i16 intermediate never wraps
# for <=12-bit pixels), so the batched version runs ONE program and per-block
# subpel phases become an (N, 8) tap gather.


def _filter_table(length: int, mode: int = 0) -> np.ndarray:
    """(16, 8) tap table for this block length / filter mode."""
    idx = mode if (mode == 3 or length > 4) else min(mode, 1) + 4
    return SUBPEL_FILTERS[idx]


@device_cache
def _filter_table_on(length: int, device) -> torch.Tensor:
    return torch.as_tensor(_filter_table(length), dtype=_I32, device=device)


def mc_gather_windows(ref_pad, iy0, ix0, h: int, w: int):
    """ref_pad: (H, W) padded plane; iy0/ix0: (N,) int32 top-left indices
    INTO THE PADDED ARRAY of the (h+7, w+7) support window.
    Returns (N, h + 7, w + 7) int32."""
    dev = ref_pad.device
    iy = iy0[:, None, None] + torch.arange(h + 7, dtype=_I32, device=dev)[None, :, None]
    ix = ix0[:, None, None] + torch.arange(w + 7, dtype=_I32, device=dev)[None, None, :]
    return ref_pad[iy, ix].to(_I32)


def mc_gather_windows_ref(ref_stack, ridx, iy0, ix0, h: int, w: int):
    """Window gather with a per-block leading reference select:
    ref_stack (R, H, W), ridx (N,) int32 -> (N, h+7, w+7) int32."""
    dev = ref_stack.device
    iy = iy0[:, None, None] + torch.arange(h + 7, dtype=_I32, device=dev)[None, :, None]
    ix = ix0[:, None, None] + torch.arange(w + 7, dtype=_I32, device=dev)[None, None, :]
    return ref_stack[ridx[:, None, None], iy, ix].to(_I32)


def _mc_two_stage(win, xf, yf, h: int, w: int, bd: int):
    """Shared 8-tap horizontal+vertical stages.

    win: (N, h+7, w+7) int32; xf/yf: (N, 8) int32 taps.
    Returns the pre-final (N, h, w) int32 accumulator after the vertical
    stage WITHOUT the final shift (callers apply put/prep finals)."""
    inter_bits = 4 - (2 if bd == 12 else 0)
    horiz = xf[:, 0, None, None] * win[:, :, 0:w]
    for k in range(1, 8):
        horiz = horiz + xf[:, k, None, None] * win[:, :, k : k + w]
    horiz = _rs(horiz, 7 - inter_bits)
    # i16 intermediate domain (never wraps for <=12-bit input, kept for
    # bit-parity with the host kernel)
    horiz = ((horiz + (1 << 15)) & 0xFFFF) - (1 << 15)
    acc = yf[:, 0, None, None] * horiz[:, 0:h, :]
    for k in range(1, 8):
        acc = acc + yf[:, k, None, None] * horiz[:, k : k + h, :]
    return acc


def mc_put_batched(ref_pad, pad: int, pos_y, pos_x, mv_r, mv_c,
                   h: int, w: int, bd: int, xdec: int = 0, ydec: int = 0):
    """Batched put_8tap (REGULAR): (N,) blocks of static (h, w).

    ref_pad: (H+2p, W+2p) padded plane.  pos_y/pos_x: (N,) top-left PLANE
    coords (unpadded, this plane's units).  mv_r/mv_c: (N,) 1/8-pel LUMA
    motion vectors.  Returns (N, h, w) int32 prediction in [0, 2^bd)."""
    row_int = mv_r >> (3 + ydec)
    col_int = mv_c >> (3 + xdec)
    iy0 = pad + pos_y + row_int - 3
    ix0 = pad + pos_x + col_int - 3
    win = mc_gather_windows(ref_pad, iy0, ix0, h, w)
    return mc_put_from_windows(win, mv_r, mv_c, h, w, bd, xdec, ydec)


def _taps(mv_r, mv_c, h: int, w: int, xdec: int, ydec: int, device):
    row_frac = ((mv_r << (1 - ydec)) & 0xF).long()
    col_frac = ((mv_c << (1 - xdec)) & 0xF).long()
    return (_filter_table_on(w, device)[col_frac],
            _filter_table_on(h, device)[row_frac])


def mc_put_from_windows(win, mv_r, mv_c, h: int, w: int, bd: int,
                        xdec: int = 0, ydec: int = 0):
    """put_8tap over pre-gathered (N, h+7, w+7) support windows."""
    inter_bits = 4 - (2 if bd == 12 else 0)
    xf, yf = _taps(mv_r, mv_c, h, w, xdec, ydec, win.device)
    acc = _mc_two_stage(win, xf, yf, h, w, bd)
    out = _rs(acc, 7 + inter_bits)
    return torch.clamp(out, 0, (1 << bd) - 1)


PREP_BIAS = 8192


def mc_prep_from_windows(win, mv_r, mv_c, h: int, w: int, bd: int,
                         xdec: int = 0, ydec: int = 0):
    """prep_8tap over pre-gathered windows: compound intermediate (i16
    domain, no clamp)."""
    prep_bias = 0 if bd == 8 else PREP_BIAS
    xf, yf = _taps(mv_r, mv_c, h, w, xdec, ydec, win.device)
    acc = _mc_two_stage(win, xf, yf, h, w, bd)
    return _rs(acc, 7) - prep_bias


def mc_avg(t1, t2, bd: int):
    """Compound average of two prep intermediates (ops/mc.py mc_avg)."""
    inter_bits = 4 - (2 if bd == 12 else 0)
    prep_bias = 0 if bd == 8 else PREP_BIAS * 2
    v = _rs(t1 + t2 + prep_bias, inter_bits + 1)
    return torch.clamp(v, 0, (1 << bd) - 1)


# ---------------------------------------------------------------------------
# Forward transform + quantize (encoder side; bit-parity with native
# enc_fwd_quant for 8-bit input, which always satisfies its i32 fast path)
# ---------------------------------------------------------------------------


@device_cache
def _fwd_mats_f64(tx_size: TxSize, tx_type: TxType, device):
    fv, fh = _fwd_matrices_int(tx_size, tx_type)  # exact-integer float64
    return (torch.as_tensor(fv, dtype=torch.float64, device=device),
            torch.as_tensor(fh, dtype=torch.float64, device=device))


def fwd_tx_batched(res, tx_size: TxSize, tx_type: TxType):
    """(N, h, w) int32 residual -> (N, h, w) int32 coefficients.

    The exact Q12 two-stage integer product, bit-identical to the native
    i32 fast path.  Each stage is a float64 matrix product, exact because
    every partial sum is an integer below 2^31 (row L1 norms bound them for
    8-bit content, native/enc.cc:1291-1296), far inside float64's 2^53; the
    cast back to int32 is then exact, and the rounding shifts run on int32
    as in the reference (PyTorch has no int32 matmul on CUDA)."""
    fv, fh = _fwd_mats_f64(tx_size, tx_type, res.device)
    t = torch.matmul(fv, res.to(torch.float64)).to(_I32)
    t = _rs(t, FWD_MAT_SHIFT)
    c = torch.matmul(t.to(torch.float64), fh.T).to(_I32)
    c = _rs(c, FWD_MAT_SHIFT)
    w, h = tx_size.width, tx_size.height
    if w > 32:
        c[:, :, 32:].zero_()
    if h > 32:
        c[:, 32:, :].zero_()
    return c


def _per_block(q, device):
    """Scalar or (N,) quantizer -> (N,) or (1,) int32 tensor."""
    q = torch.as_tensor(q, dtype=_I32, device=device)
    return q[None] if q.dim() == 0 else q


@device_cache
def _index_on(arr_bytes: bytes, device) -> torch.Tensor:
    return torch.as_tensor(np.frombuffer(arr_bytes, dtype=np.int64).copy(),
                           device=device)


def _index(arr: np.ndarray, device) -> torch.Tensor:
    return _index_on(np.ascontiguousarray(arr, dtype=np.int64).tobytes(),
                     device)


def quantize_batched(coeffs, tx_size: TxSize, scan: np.ndarray,
                     dcq, acq, is_intra: bool):
    """Exact deadzone quantizer over (N, h, w) coefficients.

    dcq/acq: scalar ints or (N,) int32 per-block quants (segmentation).
    scan: (coded_area,) uint16 scan order over the coded (<=32x32) region.
    Returns (levels, eob): levels (N, coded_area) int32 IN SCAN ORDER, eob
    (N,) int32.  Mirrors native enc_fwd_quant's quantize stage
    (enc.cc:1365-1408) bit for bit (i32-safe for 8/10-bit)."""
    dev = coeffs.device
    w, h = tx_size.width, tx_size.height
    cw, ch = min(w, 32), min(h, 32)
    lts = get_log_tx_scale(tx_size)
    dcq = _per_block(dcq, dev)
    acq = _per_block(acq, dev)
    dc_off = dcq * (109 if is_intra else 108) // 256
    ac_off0 = acq * (98 if is_intra else 97) // 256
    ac_off1 = acq * (109 if is_intra else 108) // 256
    ac_off_eob = acq * (88 if is_intra else 44) // 256

    sub = coeffs[:, :ch, :cw].reshape(coeffs.shape[0], ch * cw)
    s = sub.index_select(1, _index(scan, dev))  # (N, area) scan-ordered

    area = cw * ch
    idx = torch.arange(area, dtype=_I32, device=dev)[None, :]

    # DC
    scaled0 = s[:, 0] << lts
    a0 = scaled0.abs()
    dc_level = (a0 + dc_off) // dcq
    dc_q = torch.sign(scaled0) * dc_level

    # deadzone EOB pre-scan over AC positions
    deadzone = (acq - ac_off_eob + (1 << lts) - 1) >> lts
    live = (s.abs() >= deadzone[:, None]) & (idx >= 1)
    eob0 = torch.where(live, idx + 1, 0).amax(dim=1)
    eob0 = torch.maximum(eob0, (dc_q != 0).to(_I32))

    # AC quantize inside [1, eob0)
    scaled = s << lts
    a = scaled.abs()
    level0 = a // acq[:, None]
    offset = torch.where(level0 > 0, ac_off1[:, None], ac_off0[:, None])
    qabs = level0 + ((a + offset) >= (level0 + 1) * acq[:, None]).to(_I32)
    qac = torch.sign(scaled) * qabs
    inside = (idx >= 1) & (idx < eob0[:, None])
    levels = torch.where(inside, qac, 0)
    levels[:, 0] = dc_q

    eob = torch.where(levels != 0, idx + 1, 0).amax(dim=1)
    return levels, eob


def scan_to_dense(levels, tx_size: TxSize, scan: np.ndarray):
    """(N, coded_area) scan-ordered levels -> (N, h, w) dense qcoeffs."""
    w, h = tx_size.width, tx_size.height
    cw, ch = min(w, 32), min(h, 32)
    inv = np.zeros(cw * ch, dtype=np.int64)
    inv[np.asarray(scan, dtype=np.int64)] = np.arange(cw * ch)
    sub = levels.index_select(1, _index(inv, levels.device)).reshape(-1, ch, cw)
    if cw == w and ch == h:
        return sub
    out = torch.zeros((levels.shape[0], h, w), dtype=_I32, device=levels.device)
    out[:, :ch, :cw] = sub
    return out


def dequant_batched(qdense, tx_size: TxSize, dcq, acq):
    """Exact dequantizer over dense (N, h, w) qcoeffs (quantize.dequantize,
    i32-safe: |level| * q < 2^31 for any codeable stream at 8/10-bit)."""
    lts = get_log_tx_scale(tx_size)
    offset = (1 << lts) - 1
    dcq = _per_block(dcq, qdense.device).reshape(-1, 1, 1)
    acq = _per_block(acq, qdense.device).reshape(-1, 1, 1)
    quant = acq.expand(qdense.shape).clone()
    quant[:, 0, 0] = dcq[:, 0, 0]
    prod = qdense * quant
    return (prod + ((prod >> 31) & offset)) >> lts


def itx_add_batched(qdense, pred, tx_size: TxSize, tx_type: TxType,
                    bd: int, dcq, acq):
    """dequant + inverse transform + add + clip: (N, h, w) recon (the exact
    decode-side pipeline, ops/transforms.inverse_transform_add)."""
    deq = dequant_batched(qdense, tx_size, dcq, acq)
    return inverse_transform_add(deq, pred, tx_size, tx_type, bd)


# ---------------------------------------------------------------------------
# Deblocking: exact whole-plane apply (ops/deblock.py, vectorised masked
# form)
# ---------------------------------------------------------------------------


def _ceil_shift(v, shift):
    return (v + (1 << shift) - 1) >> shift if shift else v


def _narrow(p1, p0, q0, q1, shift, use4):
    lo, hi = -128 << shift, (128 << shift) - 1
    pix_hi = (256 << shift) - 1
    f0 = torch.clamp(p1 - q1, lo, hi)
    base2 = f0 + 3 * (q0 - p0)
    f1_2 = torch.clamp(base2 + 4, lo, hi) >> 3
    f2_2 = torch.clamp(base2 + 3, lo, hi) >> 3
    base4 = 3 * (q0 - p0)
    f1_4 = torch.clamp(base4 + 4, lo, hi) >> 3
    f2_4 = torch.clamp(base4 + 3, lo, hi) >> 3
    f3_4 = (f1_4 + 1) >> 1
    n2 = (p1, torch.clamp(p0 + f2_2, 0, pix_hi),
          torch.clamp(q0 - f1_2, 0, pix_hi), q1)
    n4 = (
        torch.clamp(p1 + f3_4, 0, pix_hi),
        torch.clamp(p0 + f2_4, 0, pix_hi),
        torch.clamp(q0 - f1_4, 0, pix_hi),
        torch.clamp(q1 - f3_4, 0, pix_hi),
    )
    return [torch.where(use4, a4, a2) for a4, a2 in zip(n4, n2)]


def _mask_common(diffs, p0, q0, p1, q1, shift):
    m = diffs[0]
    for d in diffs[1:]:
        m = torch.maximum(m, d)
    limit_lvl = _ceil_shift(m, shift)
    blimit = (p0 - q0).abs() * 2 + (p1 - q1).abs() // 2
    blimit_lvl = (_ceil_shift(blimit, shift) - 2) // 3
    return torch.maximum(limit_lvl, blimit_lvl)


def _nhev4(p1, p0, q0, q1, shift):
    t = torch.maximum((p1 - p0).abs(), (q1 - q0).abs())
    return _ceil_shift(t, shift) << 4


def deblock_groups14(g, level, bd: int, fsize):
    """Filter (N, 4, 14) pixel groups; ``fsize`` (N,) in {0,4,6,8,14}
    selects the filter per group (0 = unfiltered).  Returns the filtered
    (N, 4, 14) groups, centred so window column 7 is q0."""
    c = [g[..., i] for i in range(14)]
    res = deblock_taps14(c, level, bd, fsize[:, None])
    return torch.stack([g[..., 0]] + res + [g[..., 13]], dim=-1)


def deblock_taps14(c, level, bd: int, fs):
    """Layout-agnostic deblock filter core: ``c`` is the 14 tap tensors
    (p6..q6, any common shape), ``fs`` the per-pixel filter-size field
    broadcastable to them.  Returns the 12 modified taps (p5..q5), new
    tensors (the inputs are not written)."""
    shift = bd - 8
    flat_t = 1 << shift
    p6, p5, p4, p3, p2, p1, p0, q0, q1, q2, q3, q4, q5, q6 = c
    ab = torch.abs
    mx = torch.maximum

    use4 = _nhev4(p1, p0, q0, q1, shift) <= level

    # per-size decision masks
    m4 = _mask_common(
        [ab(p1 - p0), ab(q1 - q0)], p0, q0, p1, q1, shift) <= level
    m6 = _mask_common(
        [ab(p2 - p1), ab(p1 - p0), ab(q2 - q1), ab(q1 - q0)],
        p0, q0, p1, q1, shift) <= level
    m8 = _mask_common(
        [ab(p3 - p2), ab(p2 - p1), ab(p1 - p0),
         ab(q3 - q2), ab(q2 - q1), ab(q1 - q0)],
        p0, q0, p1, q1, shift) <= level

    flat6 = mx(mx(ab(p1 - p0), ab(q1 - q0)),
               mx(ab(p2 - p0), ab(q2 - q0))) <= flat_t
    f8v = mx(mx(mx(ab(p1 - p0), ab(q1 - q0)), mx(ab(p2 - p0), ab(q2 - q0))),
             mx(ab(p3 - p0), ab(q3 - q0)))
    flat8 = f8v <= flat_t
    flat_out = mx(mx(mx(ab(p4 - p0), ab(q4 - q0)), mx(ab(p5 - p0), ab(q5 - q0))),
                  mx(ab(p6 - p0), ab(q6 - q0))) <= flat_t

    narrow = _narrow(p1, p0, q0, q1, shift, use4)

    # wide6 outputs (p1..q1)
    w6 = [
        (p2 * 3 + p1 * 2 + p0 * 2 + q0 + 4) >> 3,
        (p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + 4) >> 3,
        (p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + 4) >> 3,
        (p0 + q0 * 2 + q1 * 2 + q2 * 3 + 4) >> 3,
    ]
    # wide8 outputs (p2..q2)
    w8 = [
        (p3 * 3 + p2 * 2 + p1 + p0 + q0 + 4) >> 3,
        (p3 * 2 + p2 + p1 * 2 + p0 + q0 + q1 + 4) >> 3,
        (p3 + p2 + p1 + p0 * 2 + q0 + q1 + q2 + 4) >> 3,
        (p2 + p1 + p0 + q0 * 2 + q1 + q2 + q3 + 4) >> 3,
        (p1 + p0 + q0 + q1 * 2 + q2 + q3 * 2 + 4) >> 3,
        (p0 + q0 + q1 + q2 * 2 + q3 * 3 + 4) >> 3,
    ]
    # wide14 outputs (p5..q5)
    w14 = [
        (p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0 + 8) >> 4,
        (p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0 + q0 + q1 + 8) >> 4,
        (p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0 + q0 + q1 + q2 + 8) >> 4,
        (p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0 + q0 + q1 + q2 + q3 + 8) >> 4,
        (p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2 + q0 + q1 + q2 + q3 + q4 + 8) >> 4,
        (p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + q2 + q3 + q4 + q5 + 8) >> 4,
        (p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + q3 + q4 + q5 + q6 + 8) >> 4,
        (p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 * 2 + q2 * 2 + q3 + q4 + q5 + q6 * 2 + 8) >> 4,
        (p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 * 2 + q3 * 2 + q4 + q5 + q6 * 3 + 8) >> 4,
        (p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 * 2 + q4 * 2 + q5 + q6 * 4 + 8) >> 4,
        (p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 * 2 + q5 * 2 + q6 * 5 + 8) >> 4,
        (p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 * 2 + q6 * 7 + 8) >> 4,
    ]

    # compose each size's 12 outputs at positions 1..12 (p5..q5)
    out4 = [p5, p4, p3, p2] + narrow + [q2, q3, q4, q5]
    out6 = [p5, p4, p3, p2] + [
        torch.where(flat6, w, n) for w, n in zip(w6, narrow)
    ] + [q2, q3, q4, q5]
    nar8 = [p2] + narrow + [q2]
    out8 = [p5, p4, p3] + [
        torch.where(flat8, w, n) for w, n in zip(w8, nar8)
    ] + [q3, q4, q5]
    w8full = [p5, p4, p3] + w8 + [q3, q4, q5]
    nar12 = [p5, p4, p3, p2] + narrow + [q2, q3, q4, q5]
    out14 = [
        torch.where(flat8, torch.where(flat_out, wf, w8f), nr)
        for wf, w8f, nr in zip(w14, w8full, nar12)
    ]

    sel4 = (fs == 4) & m4
    sel6 = (fs == 6) & m6
    sel8 = (fs == 8) & m8
    sel14 = (fs == 14) & m8
    res = []
    for i in range(12):
        res.append(torch.where(
            sel4, out4[i],
            torch.where(sel6, out6[i],
                        torch.where(sel8, out8[i],
                                    torch.where(sel14, out14[i], c[i + 1])))))
    return res


def check_deblock_inputs(rec, fsize_grid, level, bd: int) -> None:
    """Raise unless the arguments are what csrc/deblock.cu reads, on any
    device: int32 contiguous planes, a plane padded by 8 around its
    (4*rows_p, 4*cols_p) cells, and the level an int or a 0-d int32 tensor
    beside them."""
    kernels._check_tensors("deblock_edges", rec, fsize_grid)
    if bd not in (8, 10, 12):
        raise ValueError(f"deblock_edges: bit depth {bd}")
    if rec.dim() != 2 or fsize_grid.dim() != 2:
        raise ValueError("deblock_edges: expects a 2-D plane and grid")
    rows_p, cols_p = fsize_grid.shape
    if rec.shape[0] < 4 * rows_p + 16 or rec.shape[1] < 4 * cols_p + 16:
        raise ValueError(f"deblock_edges: plane {tuple(rec.shape)} is not "
                         f"padded by 8 around a {rows_p}x{cols_p} cell grid")
    if isinstance(level, torch.Tensor):
        kernels._check_tensors("deblock_edges", rec, level)
        if level.dim() != 0:
            raise ValueError("deblock_edges: the level must be 0-d")


def deblock_pass_device(rec, fsize_grid, level, bd: int, vertical: bool):
    """One deblock pass over a plane: :func:`deblock_pass_plain` for a CPU
    tensor, csrc/deblock.cu's ``deblock_edges`` for a CUDA one.

    rec: (Hp, Wp) int32 plane padded by 8 on each side.  fsize_grid:
    (rows_p, cols_p) int32 filter sizes per 4x4 cell edge (0 = skip), as
    computed by ops/deblock._plane_edge_decisions.  level: an int or a 0-d
    int32 tensor (read by the kernel on the card, so a replayed graph takes
    each frame's level).  Returns the filtered padded plane as a new
    tensor."""
    if rec.device.type == "cpu":
        return deblock_pass_plain(rec, fsize_grid, level, bd, vertical)
    kernels._require_cuda("deblock_edges", rec.device)
    check_deblock_inputs(rec, fsize_grid, level, bd)
    out = torch.empty_like(rec)
    out.copy_(rec)
    rows_p, cols_p = fsize_grid.shape
    if rows_p * cols_p == 0:
        return out
    tensor_level = isinstance(level, torch.Tensor)
    dev = rec.device
    with torch.cuda.device(dev):
        code = _build.lib().r1t_deblock_edges(
            rec.data_ptr(), out.data_ptr(), fsize_grid.data_ptr(),
            level.data_ptr() if tensor_level else None,
            0 if tensor_level else int(level), rec.shape[1], rows_p, cols_p,
            bd, int(vertical), dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "deblock_edges")
    kernels._count("deblock_edges")
    return out


def deblock_pass_plain(rec, fsize_grid, level, bd: int, vertical: bool):
    """One deblock pass over a plane, in PyTorch: the plain version of
    csrc/deblock.cu (:func:`deblock_pass_device`).

    rec: (Hp, Wp) int32 plane padded by >= 8 on each side (pad static, Hp/Wp
    multiples of 4).  fsize_grid: (rows_p, cols_p) int32 filter sizes per
    4x4 cell edge (0 = skip), as computed by ops/deblock
    ._plane_edge_decisions.  level: scalar int or 0-d tensor.  Returns the
    filtered padded plane as a new tensor.

    Edges of one orientation are independent (AV1's filter-size caps give
    disjoint modified pixels, ops/deblock.py module doc), so each of the 14
    window taps is a whole-plane stride-4 slice and the filter is
    elementwise over (rows, n_edges).  The taps are views of ``rec``: the
    filtered deltas go into a copy, so every tap keeps reading the unfiltered
    plane while neighbouring edges' taps k and k+4 alias the same columns."""
    pad = 8
    rows_p, cols_p = fsize_grid.shape
    out = rec.clone()
    if vertical:
        ph, n = 4 * rows_p, cols_p
        # tap k lives at column pad + 4*i + (k - 7)
        taps = [rec[pad : pad + ph, pad - 7 + k : pad - 7 + k + 4 * n : 4]
                for k in range(14)]
        fs = fsize_grid[:, None, :].expand(rows_p, 4, cols_p).reshape(ph, n)
        mods = deblock_taps14(taps, level, bd, fs)
        for k in range(1, 13):
            delta = torch.where(fs != 0, mods[k - 1] - taps[k], 0)
            out[pad : pad + ph, pad - 7 + k : pad - 7 + k + 4 * n : 4] += delta
        return out
    pw, n = 4 * cols_p, rows_p
    taps = [rec[pad - 7 + k : pad - 7 + k + 4 * n : 4, pad : pad + pw]
            for k in range(14)]
    fs = fsize_grid[:, :, None].expand(rows_p, cols_p, 4).reshape(n, pw)
    mods = deblock_taps14(taps, level, bd, fs)
    for k in range(1, 13):
        delta = torch.where(fs != 0, mods[k - 1] - taps[k], 0)
        out[pad - 7 + k : pad - 7 + k + 4 * n : 4, pad : pad + pw] += delta
    return out
