"""rav1e_tpu_torch device ME against rav1e_tpu's: the whole pyramid search
(3 full-pel levels through sad_grid, subpel refinement through satd8) must
give exactly the same MV field, on tests/test_pallas.py's rolled plane and on
a bench.py-style pan, at 8 and 10 bit."""

import functools

import numpy as np
import pytest
import torch

H, W = 128, 192


def _rolled(bd):
    rng = np.random.default_rng(2)
    luma = rng.integers(0, 256, (H, W)).astype(np.int32)
    ref = np.roll(luma, (3, -5), axis=(0, 1)).astype(np.int32)
    return luma << (bd - 8), ref << (bd - 8)


def _pan(bd):
    """bench.py's synthetic pan: blurred coarse texture, 2 px a frame, noise."""
    rng = np.random.default_rng(42)
    coarse = rng.integers(0, 256, (H // 8 + 1, W // 8 + 1))
    up = np.repeat(np.repeat(coarse, 8, axis=0), 8, axis=1).astype(np.float64)
    k = np.ones(9) / 9.0
    up = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, up)
    up = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, up)
    scene = up[:H, :W]
    frames = [
        np.clip(np.roll(scene, 2 * t, axis=1) + rng.integers(-2, 3, (H, W)),
                0, 255).astype(np.int32) << (bd - 8)
        for t in (0, 1)
    ]
    return frames[1], frames[0]


@functools.lru_cache(None)
def _ref_me(bd):
    import jax

    from rav1e_tpu.device.me import me_field

    return jax.jit(lambda a, b: me_field(a, b, bd))


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("inputs", [_rolled, _pan], ids=["rolled", "pan"])
def test_me_field_matches_reference(inputs, bd):
    import jax.numpy as jnp

    from rav1e_tpu_torch.device.me import me_field

    luma, ref = inputs(bd)
    want = np.asarray(_ref_me(bd)(jnp.asarray(luma), jnp.asarray(ref)))
    got = me_field(torch.from_numpy(luma), torch.from_numpy(ref), bd).numpy()
    assert got.dtype == np.int32 and got.shape == (H // 16, W // 16, 2)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() > 0  # the search found motion
