"""The reference's inverse transforms (``reference/av1/ops/itx.py``): held
to the specification's mathematics, and bit for bit equal to the port's
inverse transforms, which run a table of traced programs instead."""

import math

import numpy as np
import pytest

from encbench.reference.av1.ops import itx


def test_the_constant_tables_are_the_specifications():
    assert itx.COS128_LOOKUP == tuple(
        round(4096 * math.cos(math.pi * i / 128)) for i in range(65))
    assert itx.SINPI == tuple(
        round(4096 * 2 * math.sqrt(2) / 3 * math.sin(k * math.pi / 9))
        for k in range(1, 5))
    assert [itx.cos128(a) for a in (0, 64, 128, 192, 256)] == \
        [4096, 0, -4096, 0, 4096]
    assert itx.sin128(32) == itx.cos128(32) == 2896


@pytest.mark.parametrize("n", [2, 3, 4, 5, 6])
def test_dct_is_the_dct(n):
    """x[k] = sum_j X[j] w[j] cos(pi (2k+1) j / 2N), w[0] = 1/sqrt(2), else
    1, to within the rounding of its stages (a range wide enough that no
    clamp acts)."""
    N = 1 << n
    X = np.random.default_rng(n).integers(-2000, 2001, (N, 40))
    k, j = np.arange(N)[:, None], np.arange(N)[None, :]
    M = np.cos(np.pi * (2 * k + 1) * j / (2 * N))
    M[:, 0] /= math.sqrt(2)
    got = itx.inverse_dct(X.astype(np.int64), n, 40)
    assert np.abs(got - M @ X).max() <= N / 4 + 2


@pytest.mark.parametrize("n", [2, 3, 4])
def test_adst_is_the_adst(n):
    """ADST4: x[k] = sum_j X[j] (2 sqrt(2) / 3) sin(pi (k+1) (2j+1) / 9);
    ADST8 and ADST16: x[k] = sum_j X[j] sin(pi (2k+1) (2j+1) / 4N)."""
    N = 1 << n
    X = np.random.default_rng(10 + n).integers(-2000, 2001, (N, 40))
    k, j = np.arange(N)[:, None], np.arange(N)[None, :]
    if n == 2:
        M = 2 * math.sqrt(2) / 3 * np.sin(np.pi * (k + 1) * (2 * j + 1) / 9)
    else:
        M = np.sin(np.pi * (2 * k + 1) * (2 * j + 1) / (4 * N))
    got = itx.inverse_adst(X.astype(np.int64), n, 40)
    assert np.abs(got - M @ X).max() <= N / 4 + 2


def test_wht_of_a_dc_is_flat():
    """The lossless 4x4 WHT: a DC of 32 (8 after the rows' shift of 2)
    gives 2 in every sample."""
    T = np.zeros((4, 4), dtype=np.int64)
    T[0, 0] = 32
    res = itx.inverse_transform_block(T, 4, 4, "WHT_WHT", 8)
    assert (res == 2).all()


def _cases():
    from rav1e_tpu_torch.tx import TxSize, TxType, valid_av1_transform

    for ts in TxSize:
        for tt in TxType:
            if tt == TxType.WHT_WHT and ts != TxSize.TX_4X4:
                continue
            if valid_av1_transform(ts, tt):
                yield ts, tt


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_equal_to_the_ports_at_every_size_and_type(bd):
    """Every codable (size, type) pair, dense and sparse blocks, from small
    magnitudes to 2^15 (the row clamp's bound at 8 bits; larger dense
    blocks at 10 and 12 bits leave 32 bits inside the butterflies, which a
    conforming stream may not, and the port's transforms wrap there): the
    same reconstruction as the port's."""
    from rav1e_tpu_torch.ops import transforms as port

    rng = np.random.default_rng(bd)
    cases = 0
    for ts, tt in _cases():
        h, w = ts.height, ts.width
        for scale in (3, 300, 1 << 15):
            c = np.zeros((3, h, w), dtype=np.int32)
            c[:, : min(h, 32), : min(w, 32)] = rng.integers(
                -scale, scale + 1, (3, min(h, 32), min(w, 32)))
            c[1] *= rng.random((h, w)) < 0.05
            c[2, 1:] = 0
            pred = rng.integers(0, 1 << bd, c.shape)
            want = port.inverse_transform_add(c, pred, ts, tt, bd)
            got = itx.inverse_transform_add(c, pred, ts, tt, bd)
            assert np.array_equal(got, want), (ts.name, tt.name, scale)
            cases += 1
    assert cases > 300
