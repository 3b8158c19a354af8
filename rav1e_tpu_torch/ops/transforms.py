"""Batched AV1 transforms.

Two halves:

- **Inverse (normative, bit-exact)** — the AV1 spec's 1-D butterfly networks,
  executed from traced op-programs (``rav1e_tpu/data/inv_tx_programs.npz``,
  see tools/gen_tx_programs.py) with every op vectorized over a leading batch
  axis.  int32 wrap-around semantics match the spec; verified bit-exact
  against golden vectors from the reference scalar implementation
  (reference: src/transform/inverse.rs, driver at inverse.rs:1633-1692).

- **Forward (non-normative, MXU-native)** — separable matmuls against
  orthonormal basis matrices measured from the exact inverse maps, scaled so
  that forward -> quantize(step 1) -> dequantize -> normative inverse is the
  identity (the same calibration contract as the reference's
  forward_shared.rs shift schedules, reached by construction instead of by
  porting stage code).  This is the TPU-first design: on device the forward
  transform of a whole superblock row is a handful of big batched matmuls.

All entry points take/return numpy arrays shaped ``(batch, H, W)``.
"""

from __future__ import annotations

import functools

import numpy as np

from rav1e_tpu_torch import tables
from rav1e_tpu_torch.tx import (
    INV_INTERMEDIATE_SHIFTS,
    TxSize,
    TxType,
    TxType1D,
    get_1d_tx_types,
)

KIND_INPUT, KIND_BTF, KIND_ADDCLAMP, KIND_LIN, KIND_RSHIFT = 0, 1, 2, 3, 4

SQRT2_BITS = 12
SQRT2 = 5793  # 2^12 * sqrt(2)
INV_SQRT2 = 2896  # 2^12 / sqrt(2)


def _xp(a):
    """numpy: the port's host transforms take numpy arrays only (the
    reference's jax.numpy branches are left out)."""
    return np


def _round_shift(x, bit):
    if bit == 0:
        return x
    return (x + (1 << (bit - 1))) >> bit


def _clamp_value(xp, x, bit):
    return xp.clip(x, -(1 << (bit - 1)), (1 << (bit - 1)) - 1)


# ---------------------------------------------------------------------------
# 1-D inverse transforms: program interpreter
# ---------------------------------------------------------------------------

_PROGRAM_NAMES = {
    (TxType1D.DCT, 4): "dct4",
    (TxType1D.DCT, 8): "dct8",
    (TxType1D.DCT, 16): "dct16",
    (TxType1D.DCT, 32): "dct32",
    (TxType1D.DCT, 64): "dct64",
    (TxType1D.ADST, 4): "adst4",
    (TxType1D.ADST, 8): "adst8",
    (TxType1D.ADST, 16): "adst16",
    (TxType1D.FLIPADST, 4): "flipadst4",
    (TxType1D.FLIPADST, 8): "flipadst8",
    (TxType1D.FLIPADST, 16): "flipadst16",
}


@functools.lru_cache(None)
def _program(name: str):
    p = tables.inv_tx_program(name)
    # convert to plain python lists of ints for fast trace-time iteration
    return [
        (int(k), int(a), int(b), int(w0), int(w1), int(aux))
        for k, a, b, w0, w1, aux in zip(
            p["kind"], p["a"], p["b"], p["w0"], p["w1"], p["aux"]
        )
    ], [int(o) for o in p["out"]]


def _run_program(name: str, x, range_: int):
    """Run a 1-D inverse transform program over the last axis of ``x``.

    ``x``: int32 array (..., N). Returns int32 array (..., N).
    """
    xp = _xp(x)
    nodes, out_idx = _program(name)
    vals: list = [None] * len(nodes)
    i32 = xp.int32
    for i, (kind, a, b, w0, w1, aux) in enumerate(nodes):
        if kind == KIND_INPUT:
            vals[i] = x[..., aux]
        elif kind == KIND_BTF:
            # wrapping i32: products and sums wrap naturally in int32
            s = vals[a] * i32(w0) + vals[b] * i32(w1)
            vals[i] = (s + i32(1 << 11)) >> 12
        elif kind == KIND_ADDCLAMP:
            s = vals[a] * i32(w0)
            if b >= 0:
                s = s + vals[b] * i32(w1)
            vals[i] = _clamp_value(xp, s, range_)
        elif kind == KIND_LIN:
            s = vals[a] * i32(w0)
            if b >= 0:
                s = s + vals[b] * i32(w1)
            vals[i] = s
        else:  # KIND_RSHIFT
            vals[i] = _round_shift(vals[a], aux)
    return xp.stack([vals[o] for o in out_idx], axis=-1)


def _inv_identity(x, n: int):
    if n == 4:
        return _round_shift(x * _xp(x).int32(SQRT2), 12)
    if n == 8:
        return x * _xp(x).int32(2)
    if n == 16:
        return _round_shift(x * _xp(x).int32(2 * SQRT2), 12)
    assert n == 32
    return x * _xp(x).int32(4)


def _inv_wht4(x):
    """Inverse Walsh-Hadamard (lossless), spec 7.13.2.1 — last axis size 4."""
    x0, x1, x2, x3 = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    s0 = x0 + x1
    s2 = x2 - x3
    s4 = (s0 - s2) >> 1
    s3 = s4 - x3
    s1 = s4 - x1
    o0 = s0 - s3
    o3 = s2 + s1
    return _xp(x).stack([o0, s3, s1, o3], axis=-1)


def inv_tx_1d(x, tx1d: TxType1D, range_: int):
    """Apply a 1-D inverse transform along the last axis of int32 ``x``."""
    n = x.shape[-1]
    if tx1d == TxType1D.IDTX:
        return _inv_identity(x, n)
    if tx1d == TxType1D.WHT:
        return _inv_wht4(x)
    return _run_program(_PROGRAM_NAMES[(tx1d, n)], x, range_)


# ---------------------------------------------------------------------------
# 2-D inverse transform + add (spec 7.13.3; reference inverse.rs:1633)
# ---------------------------------------------------------------------------


def inverse_transform_add(coeffs, pred, tx_size: TxSize, tx_type: TxType, bd: int):
    """Reconstruct: ``clip(pred + inv_tx(coeffs))``.

    coeffs: int32 (B, H, W) dequantized coefficients in spec orientation
            (for 64-point dims, positions >= 32 must be zero).
    pred:   (B, H, W) predictor in pixel domain (any int dtype).
    Returns (B, H, W) int32 reconstruction in [0, 2^bd).
    """
    xp = _xp(coeffs)
    w, h = tx_size.width, tx_size.height
    assert coeffs.shape[-2:] == (h, w)
    if xp is np:
        # host fast path: native interpreter over the same op tables
        from rav1e_tpu_torch import native

        if native.available():
            out = np.empty(coeffs.shape, dtype=np.int32)
            for i in range(coeffs.shape[0]):
                out[i] = native.itx_inverse_add_native(
                    coeffs[i], np.asarray(pred[i]), tx_size, tx_type, bd
                )
            return out
    vert, horiz = get_1d_tx_types(tx_type)
    lossless = tx_type == TxType.WHT_WHT

    x = coeffs.astype(xp.int32)
    row_range = bd + 8
    if lossless:
        x = x >> 2
    elif tx_size.is_rect():
        x = _round_shift(x * xp.int32(INV_SQRT2), SQRT2_BITS)
    x = _clamp_value(xp, x, row_range)

    # row pass (horizontal transform along W)
    x = inv_tx_1d(x, horiz, row_range)

    # intermediate shift + clamp
    col_range = max(bd + 6, 16)
    if not lossless:
        x = _round_shift(x, INV_INTERMEDIATE_SHIFTS[tx_size])
    x = _clamp_value(xp, x, col_range)

    # column pass (vertical transform along H): transpose, apply, transpose
    x = xp.swapaxes(x, -1, -2)
    x = inv_tx_1d(x, vert, col_range)
    x = xp.swapaxes(x, -1, -2)

    if not lossless:
        x = _round_shift(x, 4)
    recon = pred.astype(xp.int32) + x
    return xp.clip(recon, 0, (1 << bd) - 1)


def inverse_transform_residual(coeffs, tx_size: TxSize, tx_type: TxType, bd: int):
    """The residual the decoder will add (same pipeline, no pred/clip)."""
    xp = _xp(coeffs)
    w, h = tx_size.width, tx_size.height
    vert, horiz = get_1d_tx_types(tx_type)
    lossless = tx_type == TxType.WHT_WHT
    x = coeffs.astype(xp.int32)
    row_range = bd + 8
    if lossless:
        x = x >> 2
    elif tx_size.is_rect():
        x = _round_shift(x * xp.int32(INV_SQRT2), SQRT2_BITS)
    x = _clamp_value(xp, x, row_range)
    x = inv_tx_1d(x, horiz, row_range)
    col_range = max(bd + 6, 16)
    if not lossless:
        x = _round_shift(x, INV_INTERMEDIATE_SHIFTS[tx_size])
    x = _clamp_value(xp, x, col_range)
    x = xp.swapaxes(x, -1, -2)
    x = inv_tx_1d(x, vert, col_range)
    x = xp.swapaxes(x, -1, -2)
    if not lossless:
        x = _round_shift(x, 4)
    return x


# ---------------------------------------------------------------------------
# Forward transforms (MXU matmul design)
# ---------------------------------------------------------------------------


@functools.lru_cache(None)
def _measured_inverse_map(tx1d: TxType1D, n: int) -> np.ndarray:
    """Measure the exact inverse's linear map M (float64, n x n) by impulses."""
    scale = 1 << 10
    eye = np.eye(n, dtype=np.int32) * scale
    out = inv_tx_1d(eye, tx1d, 30)  # wide range: no clamping during probe
    # row i of `out` is M @ e_i (the i-th *column* of M) -> transpose back
    return out.astype(np.float64).T / scale


@functools.lru_cache(None)
def _fwd_basis(tx1d: TxType1D, n: int) -> "tuple[np.ndarray, float]":
    """Orthonormal forward basis F (so F = closest orthogonal to M_inv^T)
    and the inverse map's gain g (M_inv ~ g * O)."""
    m = _measured_inverse_map(tx1d, n)
    u, s, vt = np.linalg.svd(m)
    o = u @ vt  # closest orthogonal matrix to M_inv
    g = float(np.mean(s))
    # forward basis: inverse of O is O^T; forward rows transform data -> freq
    return o.T, g


FWD_MAT_SHIFT = 12


@functools.lru_cache(None)
def _fwd_matrices_int(tx_size: TxSize, tx_type: TxType):
    """Integer (Q12) forward matrices stored as exact-integer float64.

    All products/sums stay below 2^53, so float64 BLAS matmuls over these are
    EXACT integer arithmetic — bit-identical to an int64 loop (the native
    path computes the same thing in C)."""
    fv, fh = _fwd_matrices(tx_size, tx_type)
    scale = 1 << FWD_MAT_SHIFT
    return np.rint(fv * scale), np.rint(fh * scale)


@functools.lru_cache(None)
def _fwd_matrices(tx_size: TxSize, tx_type: TxType):
    """Per-axis forward matrices (float64) with calibrated 2-D gain.

    Contract: let C = Fv @ X @ Fh^T (row basis applied along H, col along W).
    The normative inverse pipeline has total gain
    ``rect * g_h * g_v * 2^-(inter_shift + 4)`` so we need forward gain
    ``2^(inter_shift+4) / (rect * g_h * g_v)`` for unit round trip; the
    quantizer's Q3 scaling and log_tx_scale cancel by design (see
    quantize.py).
    """
    vert, horiz = get_1d_tx_types(tx_type)
    w, h = tx_size.width, tx_size.height
    fh, gh = _fwd_basis(horiz, w)
    fv, gv = _fwd_basis(vert, h)
    rect = (INV_SQRT2 / 4096.0) if tx_size.is_rect() else 1.0
    gain = (1 << (INV_INTERMEDIATE_SHIFTS[tx_size] + 4)) / (rect * gh * gv)
    # split the gain evenly so intermediate magnitudes stay balanced
    ssplit = np.sqrt(gain)
    return fv * ssplit, fh * ssplit


def forward_transform(residual, tx_size: TxSize, tx_type: TxType, bd: int):
    """Forward 2-D transform of (B, H, W) residuals -> int32 coefficients.

    Output is in spec orientation; for 64-point dimensions the out-of-range
    coefficients (>=32) are zeroed as the bitstream cannot code them.
    """
    xp = _xp(residual)
    w, h = tx_size.width, tx_size.height
    assert residual.shape[-2:] == (h, w)
    if tx_type == TxType.WHT_WHT:
        return _fwd_wht4(residual)
    # integer-exact Q12 pipeline (matches native/enc.cc bit-for-bit):
    # float64 matmuls over exact-integer matrices never exceed 2^53
    fv_i, fh_i = _fwd_matrices_int(tx_size, tx_type)
    half = float(1 << (FWD_MAT_SHIFT - 1))
    div = float(1 << FWD_MAT_SHIFT)
    t = fv_i @ residual.astype(np.float64)
    t = np.floor((t + half) / div)
    c = t @ fh_i.T
    c = np.floor((c + half) / div)
    c = c.astype(np.int32)
    if w > 32:
        c = _zero_high(xp, c, axis=-1)
    if h > 32:
        c = _zero_high(xp, c, axis=-2)
    return c


def _zero_high(xp, c, axis):
    n = c.shape[axis]
    idx = xp.arange(n)
    shape = [1] * c.ndim
    shape[axis] = n
    mask = (idx < 32).reshape(shape)
    return xp.where(mask, c, xp.zeros_like(c))


def _inv_wht4_undo(o):
    """Exact algebraic inversion of :func:`_inv_wht4` along the last axis.

    Derived by solving the inverse network: with out = [s0-s3, s3, s1, s2+s1]
    the unique pre-image is recovered via the same shared (s0-s2)>>1 term,
    so forward->inverse is lossless for all integer inputs.
    """
    xp = _xp(o)
    o0, o1, o2, o3 = o[..., 0], o[..., 1], o[..., 2], o[..., 3]
    s0 = o0 + o1
    s2 = o3 - o2
    s4 = (s0 - s2) >> 1
    x3 = s4 - o1
    x1 = s4 - o2
    x0 = s0 - x1
    x2 = s2 + x3
    return xp.stack([x0, x1, x2, x3], axis=-1)


def _fwd_wht4(residual):
    """Forward Walsh-Hadamard for lossless mode: the exact inverse of the
    normative decode pipeline (which computes cols(rows(coeffs >> 2)))."""
    xp = _xp(residual)
    x = residual.astype(xp.int32)
    # undo the column (vertical) pass first, then the row pass
    x = xp.swapaxes(x, -1, -2)
    x = _inv_wht4_undo(x)
    x = xp.swapaxes(x, -1, -2)
    x = _inv_wht4_undo(x)
    return x << 2
