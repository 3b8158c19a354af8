"""rav1e_tpu_torch whole-frame analysis against rav1e_tpu's.

- predict_all_modes: exactly equal (13 modes, the normative IEF path);
- tx_rd_estimate: float32 agreement only, because the DCT projection sums in
  another order than XLA's (see test_tx_rd_estimate_close for the bound);
- analyze_frame: DeviceMaps exactly equal (decisions and MV fields; bits_est
  to 1/16) for key, inter, inter+bwd and inter+bwd2 frames at 128x192.
"""

import numpy as np
import pytest
import torch

from rav1e_tpu import tables

H, W = 128, 192


@pytest.fixture
def single_device_reference(monkeypatch):
    """Run the reference's analysis on one device: under tests/conftest.py it
    would row-shard over 8 virtual CPU devices (same bits, slower compile)."""
    from rav1e_tpu.device import analysis as ana

    monkeypatch.setenv("RAV1E_TPU_NO_SHARD", "1")
    ana._analysis_mesh.cache_clear()
    yield ana
    # emptied before monkeypatch restores the variable: the next call
    # rebuilds the mesh under the restored environment
    ana._analysis_mesh.cache_clear()


@pytest.mark.parametrize("s", [8, 16, 32, 64])
@pytest.mark.parametrize("bd", [8, 10])
def test_predict_all_modes_matches_reference(s, bd):
    import jax.numpy as jnp

    from rav1e_tpu.device.analysis import predict_all_modes as ref_pred
    from rav1e_tpu_torch.device.analysis import predict_all_modes

    rng = np.random.default_rng(100 + s + bd)
    n = 6
    hi = 1 << bd
    above2 = rng.integers(0, hi, (n, 2 * s)).astype(np.int32)
    left2 = rng.integers(0, hi, (n, 2 * s)).astype(np.int32)
    tl = rng.integers(0, hi, (n,)).astype(np.int32)
    want = np.asarray(ref_pred(jnp.asarray(above2), jnp.asarray(left2),
                               jnp.asarray(tl), s, bd))
    got = predict_all_modes(torch.from_numpy(above2), torch.from_numpy(left2),
                            torch.from_numpy(tl), s, bd).numpy()
    assert got.dtype == np.int32 and got.shape == (n, 13, s, s)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("s", [8, 16, 32, 64])
def test_tx_rd_estimate_close(s):
    """Bits within rtol=1e-5, atol=1e-3.  The quantisation error behind the
    SSE cancels (|coeff| - level * q), so its float32 rounding is relative
    to the coefficients, not to the SSE: the SSE bound is 1e-5 of the
    residual's energy (which equals the coefficients' by Parseval)."""
    import jax.numpy as jnp

    from rav1e_tpu.device.analysis import tx_rd_estimate as ref_est
    from rav1e_tpu_torch.device.analysis import tx_rd_estimate

    rng = np.random.default_rng(7 + s)
    for mag, q in ((255, 20.0), (64, 112.0), (16, 600.0)):
        res = rng.integers(-mag, mag + 1, (24, s, s)).astype(np.int32)
        rb, rs = map(np.asarray, ref_est(jnp.asarray(res), s, jnp.float32(q)))
        gb, gs = tx_rd_estimate(torch.from_numpy(res), s,
                                torch.tensor(q, dtype=torch.float32))
        np.testing.assert_allclose(gb.numpy(), rb, rtol=1e-5, atol=1e-3)
        energy = (res.astype(np.float64) ** 2).sum(axis=(1, 2))
        assert np.all(np.abs(gs.numpy() - rs) <= 1e-5 * energy + 1e-3)


def _frames(n):
    rng = np.random.default_rng(77)
    coarse = rng.integers(0, 256, (H // 8 + 2, W // 8 + 2))
    base = np.repeat(np.repeat(coarse, 8, 0), 8, 1)[:H, :W]
    return [
        np.clip(np.roll(base, 2 * t, axis=1) + rng.integers(-2, 3, (H, W)),
                0, 255).astype(np.uint8)
        for t in range(n)
    ]


@pytest.mark.parametrize("kind", ["key", "inter", "inter+bwd", "inter+bwd2"])
def test_analyze_frame_matches_reference(kind, single_device_reference):
    from rav1e_tpu_torch.device.analysis import analyze_frame

    f = _frames(4)
    cur, refs = {
        "key": (f[0], (None, None, None)),
        "inter": (f[1], (f[0], None, None)),
        "inter+bwd": (f[1], (f[0], f[2], None)),
        "inter+bwd2": (f[1], (f[0], f[2], f[3])),
    }[kind]
    qi = 115
    q_step = tables.ac_q(qi, 0, 8) / 8.0
    lam = 0.12 * q_step * q_step
    want = single_device_reference.analyze_frame(
        cur, refs[0], refs[1], qi, lam, 8, ref2_np=refs[2])
    got = analyze_frame(cur, refs[0], refs[1], qi, lam, 8, ref2_np=refs[2],
                        device="cpu")
    for name in ("size_log2", "mode", "use_inter", "mv0", "mv1", "mv2"):
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert abs(got.bits_est - want.bits_est) <= 1 / 16
    if kind != "key":
        assert got.use_inter.any() and np.abs(got.mv0).max() > 0
