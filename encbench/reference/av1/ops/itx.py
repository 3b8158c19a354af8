"""The AV1 inverse transforms, written from the AV1 specification.

Section 7.13.2 of the AV1 bitstream specification defines each 1-D inverse
transform as a sequence of butterfly steps on an array ``T``: ``B(a, b,
angle, flip)``, a rotation by ``angle`` (in 1/128ths of pi) rounded to 12
fractional bits, and ``H(a, b, flip, r)``, a sum and a difference. Section
7.13.3 defines the 2-D inverse transform from them: the row transforms, an
intermediate rounding and clamp, the column transforms and a final
rounding. This module is that text, step for step; it uses no table or code
of the encoder. Each step runs over every row (or column) of a block at
once: ``T`` is an (n, rows) int64 array.

``H`` clamps its results to ``r`` bits. The specification asks a conforming
stream to keep them inside that range, so on such a stream the clamp
changes nothing; it makes the result defined on any stream, as libaom's
and dav1d's decoders do.
"""

from __future__ import annotations

import functools

import numpy as np

# cos128_lookup (7.13.2.1): round(4096 * cos(i * pi / 128)), i = 0..64
COS128_LOOKUP = (
    4096, 4095, 4091, 4085, 4076, 4065, 4052, 4036, 4017, 3996, 3973, 3948,
    3920, 3889, 3857, 3822, 3784, 3745, 3703, 3659, 3612, 3564, 3513, 3461,
    3406, 3349, 3290, 3229, 3166, 3102, 3035, 2967, 2896, 2824, 2751, 2675,
    2598, 2520, 2440, 2359, 2276, 2191, 2106, 2019, 1931, 1842, 1751, 1660,
    1567, 1474, 1380, 1285, 1189, 1092, 995, 897, 799, 700, 601, 501, 401,
    301, 201, 101, 0,
)
# SINPI_1_9 .. SINPI_4_9 (7.13.2.6)
SINPI = (1321, 2482, 3344, 3803)

# Transform_Row_Shift (7.13.3), by transform width x height
ROW_SHIFT = {
    (4, 4): 0, (8, 8): 1, (16, 16): 2, (32, 32): 2, (64, 64): 2,
    (4, 8): 0, (8, 4): 0, (8, 16): 1, (16, 8): 1, (16, 32): 1, (32, 16): 1,
    (32, 64): 1, (64, 32): 1, (4, 16): 1, (16, 4): 1, (8, 32): 2,
    (32, 8): 2, (16, 64): 2, (64, 16): 2,
}


def cos128(angle: int) -> int:
    a = angle & 255
    if a <= 64:
        return COS128_LOOKUP[a]
    if a <= 128:
        return -COS128_LOOKUP[128 - a]
    if a <= 192:
        return -COS128_LOOKUP[a - 128]
    return COS128_LOOKUP[256 - a]


def sin128(angle: int) -> int:
    return cos128(angle - 64)


def brev(num_bits: int, x: int) -> int:
    return int(format(x, f"0{num_bits}b")[::-1], 2) if num_bits else 0


def round2(x, n: int):
    if n == 0:
        return x
    return (x + (1 << (n - 1))) >> n


# ---------------------------------------------------------------------------
# The butterfly steps, each over a list of index pairs at once
# ---------------------------------------------------------------------------


# A step is (rotation?, read indices, write indices, 2x2 weights per pair):
# pair i reads (T[read[i]], T[read[k + i]]), multiplies by its weights and
# writes the two results to T[write[i]] and T[write[k + i]].


def _b(pairs, flip):
    """One step of B(a, b, angle, flip) calls: ``pairs`` of (a, b, angle).
    B(a, b, angle, 0) sets T[a] = Round2(T[a] cos - T[b] sin, 12) and
    T[b] = Round2(T[a] sin + T[b] cos, 12); with flip 1 the two results are
    then exchanged."""
    a = [p[0] for p in pairs]
    b = [p[1] for p in pairs]
    w = np.array([[[cos128(p[2]), -sin128(p[2])],
                   [sin128(p[2]), cos128(p[2])]] for p in pairs],
                 dtype=np.int64)
    return (True, np.array(a + b), np.array(b + a if flip else a + b), w)


def _h(pairs):
    """One step of H(a, b, flip, r) calls: ``pairs`` of (a, b, flip).
    H(a, b, 0, r) sets T[a] = T[a] + T[b] and T[b] = T[a] - T[b];
    H(a, b, 1, r) is H(b, a, 0, r)."""
    a = [p[1] if p[2] else p[0] for p in pairs]
    b = [p[0] if p[2] else p[1] for p in pairs]
    idx = np.array(a + b)
    return (False, idx, idx, np.array([[[1, 1], [1, -1]]], dtype=np.int64))


def _dct_perm(n):
    """The inverse DCT array permutation (7.13.2.2): T[i] = copyT[brev(n, i)]."""
    return np.array([brev(n, i) for i in range(1 << n)])


@functools.lru_cache(None)
def dct_steps(n: int):
    """The inverse DCT process (7.13.2.3) for 2^n points: its steps, in
    order."""
    s = []
    if n == 6:
        s.append(_b([(32 + i, 63 - i, 63 - 4 * brev(4, i))
                     for i in range(16)], 0))
    if n >= 5:
        s.append(_b([(16 + i, 31 - i, 6 + (brev(3, 7 - i) << 3))
                     for i in range(8)], 0))
    if n == 6:
        s.append(_h([(32 + i * 2, 33 + i * 2, i & 1) for i in range(16)]))
    if n >= 4:
        s.append(_b([(8 + i, 15 - i, 12 + (brev(2, 3 - i) << 4))
                     for i in range(4)], 0))
    if n >= 5:
        s.append(_h([(16 + 2 * i, 17 + 2 * i, i & 1) for i in range(8)]))
    if n == 6:
        s.append(_b([(62 - i * 4 - j, 33 + i * 4 + j,
                      60 - 16 * brev(2, i) + 64 * j)
                     for i in range(4) for j in range(2)], 1))
    if n >= 3:
        s.append(_b([(4 + i, 7 - i, 56 - 32 * i) for i in range(2)], 0))
    if n >= 4:
        s.append(_h([(8 + 2 * i, 9 + 2 * i, i & 1) for i in range(4)]))
    if n >= 5:
        s.append(_b([(30 - 4 * i - j, 17 + 4 * i + j,
                      24 + (j << 6) + ((1 - i) << 5))
                     for i in range(2) for j in range(2)], 1))
    if n == 6:
        s.append(_h([(32 + i * 4 + j, 35 + i * 4 - j, i & 1)
                     for i in range(8) for j in range(2)]))
    s.append(_b([(0, 1, 32)], 1))
    s.append(_b([(2, 3, 48)], 0))
    if n >= 3:
        s.append(_h([(4 + 2 * i, 5 + 2 * i, i & 1) for i in range(2)]))
    if n >= 4:
        s.append(_b([(14, 9, 48), (13, 10, 112)], 1))
    if n >= 5:
        s.append(_h([(16 + 4 * i + j, 19 + 4 * i - j, i & 1)
                     for i in range(4) for j in range(2)]))
    if n == 6:
        s.append(_b([(61 - i * 8 - j, 34 + i * 8 + j,
                      56 - i * 32 + (j >> 1) * 64)
                     for i in range(2) for j in range(4)], 1))
    s.append(_h([(0, 3, 0), (1, 2, 0)]))
    if n >= 3:
        s.append(_b([(6, 5, 32)], 1))
    if n >= 4:
        s.append(_h([(8 + 4 * i + j, 11 + 4 * i - j, i & 1)
                     for i in range(2) for j in range(2)]))
    if n >= 5:
        s.append(_b([(29 - i, 18 + i, 48 + (i >> 1) * 64)
                     for i in range(4)], 1))
    if n == 6:
        s.append(_h([(32 + 8 * i + j, 39 + 8 * i - j, i & 1)
                     for i in range(4) for j in range(4)]))
    if n >= 3:
        s.append(_h([(i, 7 - i, 0) for i in range(4)]))
    if n >= 4:
        s.append(_b([(13 - i, 10 + i, 32) for i in range(2)], 1))
    if n >= 5:
        s.append(_h([(16 + i * 8 + j, 23 + i * 8 - j, i & 1)
                     for i in range(2) for j in range(4)]))
    if n == 6:
        s.append(_b([(59 - i, 36 + i, 48 if i < 4 else 112)
                     for i in range(8)], 1))
    if n >= 4:
        s.append(_h([(i, 15 - i, 0) for i in range(8)]))
    if n >= 5:
        s.append(_b([(27 - i, 20 + i, 32) for i in range(4)], 1))
    if n == 6:
        s.append(_h([(32 + i * 16 + j, 47 + i * 16 - j, i & 1)
                     for i in range(2) for j in range(8)]))
    if n >= 5:
        s.append(_h([(i, 31 - i, 0) for i in range(16)]))
    if n == 6:
        s.append(_b([(55 - i, 40 + i, 32) for i in range(8)], 1))
    if n == 6:
        s.append(_h([(i, 63 - i, 0) for i in range(32)]))
    return _dct_perm(n), s


def _adst_in_perm(n):
    """The inverse ADST input array permutation (7.13.2.4)."""
    n0 = 1 << n
    return np.array([(i - 1) if i & 1 else (n0 - i - 1) for i in range(n0)])


def _adst_out_perm(n):
    """The inverse ADST output array permutation (7.13.2.5): (indices,
    signs)."""
    idx, sign = [], []
    for i in range(1 << n):
        a = (i >> 3) & 1
        b = ((i >> 2) & 1) ^ ((i >> 3) & 1)
        c = ((i >> 1) & 1) ^ ((i >> 2) & 1)
        d = (i & 1) ^ ((i >> 1) & 1)
        idx.append(((d << 3) | (c << 2) | (b << 1) | a) >> (4 - n))
        sign.append(-1 if i & 1 else 1)
    return np.array(idx), np.array(sign, dtype=np.int64)[:, None]


@functools.lru_cache(None)
def adst_steps(n: int):
    """The inverse ADST8 (7.13.2.7) and ADST16 (7.13.2.8) processes: their
    steps, in order, between the input and output permutations."""
    s = []
    if n == 3:
        s.append(_b([(2 * i, 1 + 2 * i, 60 - 16 * i) for i in range(4)], 1))
        s.append(_h([(i, 4 + i, 0) for i in range(4)]))
        s.append(_b([(4 + 3 * i, 5 + i, 48 - 32 * i) for i in range(2)], 1))
        s.append(_h([(4 * j + i, 2 + 4 * j + i, 0)
                     for i in range(2) for j in range(2)]))
        s.append(_b([(2 + 4 * i, 3 + 4 * i, 32) for i in range(2)], 1))
    else:
        assert n == 4
        s.append(_b([(2 * i, 1 + 2 * i, 62 - 8 * i) for i in range(8)], 1))
        s.append(_h([(i, 8 + i, 0) for i in range(8)]))
        s.append(_b([(8 + 2 * i, 9 + 2 * i, 56 - 32 * i) for i in range(2)]
                    + [(13 + 2 * i, 12 + 2 * i, 8 + 32 * i)
                       for i in range(2)], 1))
        s.append(_h([(8 * j + i, 4 + 8 * j + i, 0)
                     for i in range(4) for j in range(2)]))
        s.append(_b([(4 + 8 * j + 3 * i, 5 + 8 * j + i, 48 - 32 * i)
                     for i in range(2) for j in range(2)], 1))
        s.append(_h([(4 * j + i, 2 + 4 * j + i, 0)
                     for i in range(2) for j in range(4)]))
        s.append(_b([(2 + 4 * i, 3 + 4 * i, 32) for i in range(4)], 1))
    return _adst_in_perm(n), s, _adst_out_perm(n)


def _run(T, steps, r):
    lo, hi = -(1 << (r - 1)), (1 << (r - 1)) - 1
    for rotation, read, write, w in steps:
        k = len(read) // 2
        y = w @ T[read].reshape(2, k, -1).transpose(1, 0, 2)
        if rotation:
            y = round2(y, 12)
        else:
            np.clip(y, lo, hi, out=y)
        T[write] = y.transpose(1, 0, 2).reshape(2 * k, -1)
    return T


def inverse_dct(T, n: int, r: int):
    perm, steps = dct_steps(n)
    return _run(T[perm], steps, r)


def inverse_adst4(T):
    """The inverse ADST4 process (7.13.2.6)."""
    s1_9, s2_9, s3_9, s4_9 = SINPI
    s0 = s1_9 * T[0]
    s1 = s2_9 * T[0]
    s2 = s3_9 * T[1]
    s3 = s4_9 * T[2]
    s4 = s1_9 * T[2]
    s5 = s2_9 * T[3]
    s6 = s4_9 * T[3]
    a7 = T[0] - T[2]
    b7 = a7 + T[3]
    s0 = s0 + s3
    s1 = s1 - s4
    s3 = s2
    s2 = s3_9 * b7
    s0 = s0 + s5
    s1 = s1 - s6
    x0 = s0 + s3
    x1 = s1 + s3
    x2 = s2
    x3 = s0 + s1
    x3 = x3 - s3
    return np.stack([round2(x0, 12), round2(x1, 12), round2(x2, 12),
                     round2(x3, 12)])


def inverse_adst(T, n: int, r: int):
    if n == 2:
        return inverse_adst4(T)
    perm, steps, (out, sign) = adst_steps(n)
    return _run(T[perm], steps, r)[out] * sign


def inverse_identity(T, n: int):
    """The inverse identity transform process (7.13.2.15)."""
    if n == 2:
        return round2(T * 5793, 12)
    if n == 3:
        return T * 2
    if n == 4:
        return round2(T * 11586, 12)
    assert n == 5
    return T * 4


def inverse_wht(T, shift: int):
    """The inverse Walsh-Hadamard transform process (7.13.2.10)."""
    a = T[0] >> shift
    c = T[1] >> shift
    d = T[2] >> shift
    b = T[3] >> shift
    a = a + c
    d = d - b
    e = (a - d) >> 1
    b = e - b
    c = e - c
    a = a - b
    d = d + c
    return np.stack([a, b, c, d])


# the 1-D types of each 2-D type, by its name: (column, row)
_KINDS = {"DCT": "dct", "ADST": "adst", "FLIPADST": "flipadst",
          "IDTX": "identity", "WHT": "wht"}


def tx_kinds(name: str):
    """(vertical, horizontal) 1-D types of the 2-D transform type ``name``
    (DCT_ADST: a DCT down the columns, an ADST along the rows; V_DCT: a DCT
    down the columns, the identity along the rows; H_DCT the other way)."""
    if name == "IDTX":
        return "identity", "identity"
    if name.startswith("V_"):
        return _KINDS[name[2:]], "identity"
    if name.startswith("H_"):
        return "identity", _KINDS[name[2:]]
    v, h = name.split("_")
    return _KINDS[v], _KINDS[h]


def _one_d(T, kind: str, n: int, r: int, lossless_shift: int):
    if kind == "dct":
        return inverse_dct(T, n, r)
    if kind in ("adst", "flipadst"):
        return inverse_adst(T, n, r)
    if kind == "identity":
        return inverse_identity(T, n)
    return inverse_wht(T, lossless_shift)


def inverse_transform_block(coeffs, w: int, h: int, tx_name: str, bd: int):
    """The 2-D inverse transform process (7.13.3) of one ``h x w`` block of
    dequantized coefficients (row-major, spec orientation): its residual,
    flips applied, as int64."""
    log2w, log2h = w.bit_length() - 1, h.bit_length() - 1
    vert, horiz = tx_kinds(tx_name)
    lossless = tx_name == "WHT_WHT"
    row_shift = 0 if lossless else ROW_SHIFT[(w, h)]
    col_shift = 0 if lossless else 4
    row_r = bd + 8
    col_r = max(bd + 6, 16)

    d = np.zeros((h, w), dtype=np.int64)
    d[: min(h, 32), : min(w, 32)] = coeffs[: min(h, 32), : min(w, 32)]
    # every 1-D transform takes a row of zeros to zeros, so only the rows
    # that hold a coefficient are transformed
    rows = np.flatnonzero(d.any(axis=1))
    T = d[rows].T.copy()  # row rows[k] of the block is column k of T
    if abs(log2w - log2h) == 1:
        T = round2(T * 2896, 12)
    if not lossless:
        T = np.clip(T, -(1 << (bd + 7)), (1 << (bd + 7)) - 1)
    T = _one_d(T, horiz, log2w, row_r, 2)
    res = np.zeros((w, h), dtype=np.int64)  # res[j, i] is Residual[i][j]
    res[:, rows] = round2(T, row_shift)
    if not lossless:
        res = np.clip(res, -(1 << (col_r - 1)), (1 << (col_r - 1)) - 1)
    T = _one_d(res.T.copy(), vert, log2h, col_r, 0)
    res = round2(T, col_shift)  # (h, w)
    if vert == "flipadst":
        res = res[::-1]
    if horiz == "flipadst":
        res = res[:, ::-1]
    return res


def inverse_transform_add(coeffs, pred, tx_size, tx_type, bd: int):
    """The reconstruction of a batch of blocks: ``clip(pred + residual)``.
    ``coeffs`` and ``pred`` are (B, H, W); ``tx_size`` has ``width`` and
    ``height``, ``tx_type`` a ``name`` as the specification spells it."""
    w, h = tx_size.width, tx_size.height
    out = np.empty(np.shape(coeffs), dtype=np.int32)
    for k in range(out.shape[0]):
        res = inverse_transform_block(np.asarray(coeffs[k]), w, h,
                                      tx_type.name, bd)
        out[k] = np.clip(np.asarray(pred[k], dtype=np.int64) + res, 0,
                         (1 << bd) - 1)
    return out
