"""rav1e_tpu_torch device ME against rav1e_tpu's: the whole pyramid search
(3 full-pel levels through grid_search, subpel refinement through satd8) must
give exactly the same MV field, on tests/test_pallas.py's rolled plane and on
a bench.py-style pan, at 8 and 10 bit.  Each of me_field's four full-pel
rounds, through grid_search's plain version, must give exactly the MVs of
the reference's _grid_search on the same inputs, there and on a flat plane
(every key ties within a seed) and at a ragged block count."""

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


# me_field's four full-pel rounds: (level, R, step, seeds)
ROUNDS = [("L2", 3, 2, 1), ("L2", 1, 1, 1), ("L1", 2, 1, 2), ("L0", 2, 1, 2)]


def _round_inputs(luma, ref, bd=8):
    """The arguments of each grid_search call that me_field makes on these
    planes, in order."""
    from rav1e_tpu_torch.device import kernels, me

    calls = []
    real = kernels.grid_search

    def record(*args):
        calls.append(args)
        return real(*args)

    orig = me.kernels.grid_search
    me.kernels.grid_search = record
    try:
        me.me_field(torch.from_numpy(luma), torch.from_numpy(ref), bd)
    finally:
        me.kernels.grid_search = orig
    assert [(c[6], c[7], len(c[4])) for c in calls] == [
        (R, step, ns) for _, R, step, ns in ROUNDS]
    return calls


def _ref_round(args):
    """The reference's _grid_search (JAX on the CPU) on the same inputs."""
    import jax.numpy as jnp

    from rav1e_tpu.device.me import _grid_search

    src, ref_pad, by, bx, seeds, blk, R, step, pad_off, clip = args
    return np.asarray(_grid_search(
        jnp.asarray(src.numpy()), jnp.asarray(ref_pad.numpy()),
        jnp.asarray(by.numpy()), jnp.asarray(bx.numpy()),
        [jnp.asarray(sd.numpy()) for sd in seeds], blk, R, step, pad_off,
        clip))


def _check_round(args):
    from rav1e_tpu_torch.device import kernels

    got = kernels.grid_search_plain(*args).numpy()
    want = _ref_round(args)
    assert got.dtype == np.int32 and got.shape == (args[0].shape[0], 2)
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("rnd", range(4), ids=[
    f"{lv}-R{R}-step{st}-seeds{ns}" for lv, R, st, ns in ROUNDS])
@pytest.mark.parametrize("inputs", [_rolled, _pan], ids=["rolled", "pan"])
def test_grid_search_rounds_match_reference(inputs, rnd):
    luma, ref = inputs(8)
    args = _round_inputs(luma, ref)[rnd]
    got = _check_round(args)
    # the wrapper takes the plain version on a CPU tensor
    from rav1e_tpu_torch.device import kernels

    np.testing.assert_array_equal(kernels.grid_search(*args).numpy(), got)


@pytest.mark.parametrize("rnd", range(4), ids=[
    f"{lv}-R{R}-step{st}-seeds{ns}" for lv, R, st, ns in ROUNDS])
def test_grid_search_flat_plane_ties(rnd):
    """A flat plane: every candidate of a seed has the same SAD, so only the
    tie-break decides: the candidate nearest the earlier seed."""
    flat = np.full((H, W), 97, np.int32)
    args = list(_round_inputs(flat, flat)[rnd])
    n = args[0].shape[0]
    rng = np.random.default_rng(5 + rnd)
    clip = args[9]
    # distinct seeds per block, so the winner is seed 0's centre
    args[4] = [torch.from_numpy(rng.integers(-clip, clip + 1, (n, 2))
                                .astype(np.int32)) for _ in args[4]]
    got = _check_round(tuple(args))
    sd = np.clip(args[4][0].numpy(), -clip, clip)
    np.testing.assert_array_equal(got, sd)


@pytest.mark.parametrize("rnd", range(4), ids=[
    f"{lv}-R{R}-step{st}-seeds{ns}" for lv, R, st, ns in ROUNDS])
def test_grid_search_ragged_blocks(rnd):
    """n = 37 blocks with random origins, seeds beyond the clip and 12-bit
    samples, so that SAD ties across seeds and offsets also occur."""
    from rav1e_tpu_torch.device.constants import (
        L0_CLIP, L1_CLIP, L2_CLIP, PAD_L0, PAD_L1, PAD_L2)

    lv, R, step, ns = ROUNDS[rnd]
    pad, clip = {"L2": (PAD_L2, L2_CLIP), "L1": (PAD_L1, L1_CLIP),
                 "L0": (PAD_L0, L0_CLIP)}[lv]
    rng = np.random.default_rng(30 + rnd)
    n, h, w = 37, 96, 80
    # few distinct sample values: SAD ties are common
    ref_pad = rng.integers(0, 3, (h + 2 * pad, w + 2 * pad)) * 2047
    src = rng.integers(0, 3, (n, 16, 16)) * 2047
    by = rng.integers(0, h - 15, n)
    bx = rng.integers(0, w - 15, n)
    seeds = [rng.integers(-2 * clip, 2 * clip + 1, (n, 2)) for _ in range(ns)]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))
    _check_round((t(src), t(ref_pad), t(by), t(bx), [t(sd) for sd in seeds],
                  16, R, step, pad, clip))
