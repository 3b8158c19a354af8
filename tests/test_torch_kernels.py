"""rav1e_tpu_torch kernels: the plain PyTorch versions that a CPU tensor takes
against the reference's Pallas kernels run in interpreter mode, exactly
equal (tests/test_pallas.py's shapes, plus the encoder's path shapes and
12-bit diffs).  The CUDA kernels themselves run only on a card; chip_smoke.py
compares them with these plain versions there."""

import numpy as np
import pytest
import torch

from rav1e_tpu.device import pallas_kernels as pk
from rav1e_tpu_torch.device import _build, kernels


def _jnp(a):
    import jax.numpy as jnp

    return jnp.asarray(a)


@pytest.mark.parametrize(
    "shape,mag",
    [
        ((7, 8, 8), 1023),
        ((3, 13, 16, 16), 1023),
        ((2, 32, 32), 1023),
        ((3, 8, 8), 4095),  # 12-bit diffs: block sums stay below 2^24
        ((3, 16, 16), 4095),
        ((2, 13, 64, 64), 255),  # analysis.intra_cost_field at 64x64
        ((5, 49, 16, 16), 255),  # me._hadamard16_satd on the subpel grid
    ],
)
def test_satd8_matches_pallas(shape, mag):
    rng = np.random.default_rng(0)
    diff = rng.integers(-mag, mag + 1, shape).astype(np.int32)
    want = np.asarray(pk.satd8(_jnp(diff), interpret=True))
    got = kernels.satd8(torch.from_numpy(diff)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("blk,R,step", [(16, 3, 2), (16, 2, 1), (16, 1, 1)])
def test_sad_grid_matches_pallas(blk, R, step):
    rng = np.random.default_rng(1)
    n = 37  # not a multiple of the TPU tile
    W = blk + 2 * R * step
    src = rng.integers(0, 4096, (n, blk, blk)).astype(np.int32)
    win = rng.integers(0, 4096, (n, W, W)).astype(np.int32)
    want = np.asarray(pk.sad_grid(_jnp(src), _jnp(win), blk, R, step,
                                  interpret=True))
    got = kernels.sad_grid(torch.from_numpy(src), torch.from_numpy(win), blk,
                           R, step).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_cpu_calls_launch_no_kernel():
    kernels.reset_launches()
    kernels.satd8(torch.zeros((2, 13, 8, 8), dtype=torch.int32))
    kernels.sad_grid(torch.zeros((3, 16, 16), dtype=torch.int32),
                     torch.zeros((3, 20, 20), dtype=torch.int32), 16, 2, 1)
    assert kernels.LAUNCHES == {"satd8": 0, "sad_grid": 0}


def test_wrappers_raise_on_a_device_without_kernel():
    """No silent fallback: a tensor that is neither on the CPU nor on a CUDA
    card is refused."""
    with pytest.raises(ValueError, match="no kernel"):
        kernels.satd8(torch.empty((2, 8, 8), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        kernels.sad_grid(
            torch.empty((2, 16, 16), dtype=torch.int32, device="meta"),
            torch.empty((2, 18, 18), dtype=torch.int32, device="meta"),
            16, 1, 1,
        )


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "LIB_PATH", tmp_path / "libr1t_kernels.so")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
