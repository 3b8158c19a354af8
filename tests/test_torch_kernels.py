"""rav1e_tpu_torch kernels: the plain PyTorch versions that a CPU tensor takes
against the reference's Pallas kernels run in interpreter mode, exactly
equal (tests/test_pallas.py's shapes, plus the encoder's path shapes and
12-bit diffs).  grid_search's plain version is held against the reference's
whole round in tests/test_torch_me.py.  The CUDA kernels themselves run only
on a card; chip_smoke.py compares them with these plain versions there.  The
loader's build steps are checked here with a stand-in for nvcc."""

import functools
import json
import sys

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
    got = kernels.sad_grid_plain(torch.from_numpy(src), torch.from_numpy(win),
                                 blk, R, step).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_cpu_calls_launch_no_kernel():
    kernels.reset_launches()
    kernels.satd8(torch.zeros((2, 13, 8, 8), dtype=torch.int32))
    z = torch.zeros((3, 2), dtype=torch.int32)
    kernels.grid_search(torch.zeros((3, 16, 16), dtype=torch.int32),
                        torch.zeros((60, 60), dtype=torch.int32),
                        z[:, 0].contiguous(), z[:, 1].contiguous(), [z, z],
                        16, 2, 1, 22, 18)
    assert kernels.LAUNCHES == {"satd8": 0, "grid_search": 0}


def test_wrappers_raise_on_a_device_without_kernel():
    """No silent fallback: a tensor that is neither on the CPU nor on a CUDA
    card is refused."""
    with pytest.raises(ValueError, match="no kernel"):
        kernels.satd8(torch.empty((2, 8, 8), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        meta = functools.partial(torch.empty, dtype=torch.int32, device="meta")
        kernels.grid_search(meta((2, 16, 16)), meta((40, 40)), meta((2,)),
                            meta((2,)), [meta((2, 2))], 16, 1, 1, 17, 8)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "LIB_PATH", tmp_path / "libr1t_kernels.so")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


# a stand-in for nvcc: logs its arguments, writes its -o file, and fails on
# a source named in FAIL_ON
_FAKE_NVCC = """\
import json, os, sys
args = sys.argv[1:]
with open(os.environ["NVCC_LOG"], "a") as f:
    f.write(json.dumps(args) + "\\n")
if any(a.endswith(os.environ.get("FAIL_ON", "-")) for a in args):
    print("error: stand-in failure")
    sys.exit(2)
with open(args[args.index("-o") + 1], "w") as f:
    f.write("built")
print("ptxas info    : Used 8 registers")
"""


def _fake_nvcc(monkeypatch, tmp_path, fail_on=None):
    exe = tmp_path / "nvcc"
    exe.write_text(f"#!{sys.executable}\n{_FAKE_NVCC}")
    exe.chmod(0o755)
    log = tmp_path / "nvcc.log"
    monkeypatch.setenv("NVCC_LOG", str(log))
    if fail_on:
        monkeypatch.setenv("FAIL_ON", fail_on)
    monkeypatch.setattr(_build.shutil, "which", lambda name: str(exe))
    out = tmp_path / "out"
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    monkeypatch.setattr(_build, "LIB_PATH", out / "libr1t_kernels.so")
    monkeypatch.setattr(_build, "build_log", "")
    return log, out


def test_build_compiles_each_source_then_links(monkeypatch, tmp_path):
    log, out = _fake_nvcc(monkeypatch, tmp_path)
    assert _build.build() == out / "libr1t_kernels.so"
    calls = [json.loads(line) for line in log.read_text().splitlines()]
    srcs = _build.sources()
    assert len(srcs) >= 2 and len(calls) == len(srcs) + 1
    compiled = sorted(c[-1] for c in calls[:-1])
    assert compiled == sorted(map(str, srcs))
    assert all("-c" in c and "-shared" not in c for c in calls[:-1])
    link = calls[-1]
    assert "-shared" in link and "-c" not in link
    assert sorted(link[link.index("-o") + 2:]) == sorted(
        c[c.index("-o") + 1] for c in calls[:-1])
    # only the library and its stamp remain; a second call reuses them
    assert sorted(p.name for p in out.iterdir()) == [
        "libr1t_kernels.so", "libr1t_kernels.so.hash"]
    assert "Used 8 registers" in _build.build_log
    _build.build()
    assert len(log.read_text().splitlines()) == len(calls)


def test_build_failure_raises_and_leaves_nothing(monkeypatch, tmp_path):
    log, out = _fake_nvcc(monkeypatch, tmp_path, fail_on="grid_search.cu")
    with pytest.raises(RuntimeError, match="nvcc failed") as err:
        _build.build()
    assert "stand-in failure" in str(err.value)
    assert list(out.iterdir()) == []
