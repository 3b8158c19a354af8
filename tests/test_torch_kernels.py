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
from torch_threads import one_torch_cpu_thread  # noqa: F401


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


def satd_bound_diffs(n, m, seed=0):
    """(n, 13, 64, 64) int32 diffs at the bound of the SATD block sum: each
    8x8 cell is +-m * (-1)^popcount(x & y), an inner-product bent pattern
    whose Hadamard transform has all 64 coefficients of magnitude 8m, the
    most Cauchy-Schwarz allows (sum |H d H^T| <= 8 * ||H d H^T||_F =
    64 * 8 * ||d||_F <= 512m).  Each cell then scores floor((512m + 4) / 8)
    = 64m and each 64x64 block 4096m, at 12 bits 16,773,120 < 2^24."""
    pop = np.array([bin(v).count("1") for v in range(8)])
    x = np.arange(8)
    cell = m * (1 - 2 * (pop[x[:, None] & x[None, :]] & 1))
    sign = np.random.default_rng(seed).choice([-1, 1], (n, 13, 8, 8))
    d = sign[..., :, None, :, None] * cell[:, None, :]
    return d.reshape(n, 13, 64, 64).astype(np.int32)


def satd_exact(diff):
    """The SATD block sums of (..., 64, 64) diffs in int64, exactly."""
    h = np.array([[1]], np.int64)
    for _ in range(3):
        h = np.block([[h, h], [h, -h]])
    *lead, s, _ = diff.shape
    d = diff.astype(np.int64).reshape(*lead, s // 8, 8, s // 8, 8)
    d = np.moveaxis(d, -2, -3)
    cells = (np.abs(h @ d @ h.T).sum(axis=(-1, -2)) + 4) // 8
    return cells.sum(axis=(-1, -2))


@pytest.mark.parametrize("bd", [10, 12])
def test_satd8_block_sum_at_its_bound_is_exact(bd):
    """At the largest sum any diff of bd bits can give, the port's plain
    version, the reference's satd8 and the exact integer sum agree: every
    partial sum is an integer below 2^24, so float32 adds it exactly in any
    order."""
    import jax

    from rav1e_tpu.device import analysis as ref_analysis

    m = (1 << bd) - 1
    diff = satd_bound_diffs(2, m)
    exact = satd_exact(diff)
    assert (exact == 4096 * m).all() and exact.max() < 1 << 24
    got = kernels.satd8_plain(torch.from_numpy(diff)).numpy()
    want = np.asarray(jax.jit(ref_analysis.satd8)(_jnp(diff)))
    np.testing.assert_array_equal(got, exact.astype(np.float32))
    np.testing.assert_array_equal(want, exact.astype(np.float32))


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


def _run_threads(fn, n=16):
    """``fn`` in ``n`` threads at once with a short switch interval; their
    results, after each thread has ended."""
    import threading

    out = [None] * n
    start = threading.Barrier(n)

    def body(i):
        start.wait(timeout=60)
        out[i] = fn()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=body, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    return out


def test_launch_counts_are_exact_across_threads():
    """GOP-parallel workers count their launches from several threads: no
    update is lost."""
    kernels.reset_launches()

    def launch_many():
        for _ in range(2000):
            kernels._count("satd8")
            kernels._count("grid_search")

    _run_threads(launch_many)
    assert kernels.LAUNCHES == {"satd8": 32000, "grid_search": 32000}
    kernels.reset_launches()


def test_kernel_library_builds_once_across_threads(monkeypatch, tmp_path):
    import time

    calls = []

    def slow_build():
        calls.append(1)
        time.sleep(0.2)
        return tmp_path / "lib.so"

    class FakeLib:
        def __init__(self, path):
            self.r1t_satd8 = self.r1t_grid_search = self.r1t_error_string = (
                type("Fn", (), {})())

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    libs = _run_threads(_build.lib, n=8)
    assert len(calls) == 1
    assert all(lib is libs[0] for lib in libs)


# a stand-in for g++: logs each call, then fails
_FAKE_GXX = """\
import os, sys, time
with open(os.environ["GXX_LOG"], "a") as f:
    f.write("call\\n")
time.sleep(0.2)
print("error: stand-in g++ failure", file=sys.stderr)
sys.exit(1)
"""


@pytest.fixture
def failing_gxx(monkeypatch, tmp_path):
    """The port's native coder with no library yet and a g++ that fails;
    returns the log of g++ calls."""
    import os

    from rav1e_tpu_torch import native

    bindir = tmp_path / "bin"
    bindir.mkdir()
    exe = bindir / "g++"
    exe.write_text(f"#!{sys.executable}\n{_FAKE_GXX}")
    exe.chmod(0o755)
    log = tmp_path / "gxx.log"
    log.write_text("")
    monkeypatch.setenv("GXX_LOG", str(log))
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "_LIB", tmp_path / "librav1e_tpu_ec.so")
    monkeypatch.setattr(native, "_HASH", tmp_path / "librav1e_tpu_ec.so.hash")
    return log


def test_native_build_failure_raises_on_cuda(failing_gxx):
    """A context on a CUDA device needs the native coder (the device chain
    runs only with it): a failed build raises with g++'s output instead of
    falling back to the Python coders."""
    import rav1e_tpu_torch as r
    from rav1e_tpu_torch import native
    from rav1e_tpu_torch.encoder.pipeline import FramePipeline

    cfg = r.Config(enc=r.EncoderConfig(width=128, height=64),
                   device="cuda")
    with pytest.raises(RuntimeError, match="stand-in g\\+\\+ failure"):
        FramePipeline(cfg)
    with pytest.raises(RuntimeError, match="needs it"):
        native.require_lib()
    assert failing_gxx.read_text().count("call") == 1


def test_native_build_failure_falls_back_on_cpu(failing_gxx, capsys):
    """On the CPU device the reference's behaviour stays: a warning, the
    Python coders, and no device chain."""
    import rav1e_tpu_torch as r

    cfg = r.Config(enc=r.EncoderConfig(width=128, height=64), device="cpu")
    ctx = cfg.new_context()
    assert not ctx.pipeline._chain_applicable()
    assert "native library build FAILED" in capsys.readouterr().err


def test_native_builds_once_across_threads(failing_gxx):
    from rav1e_tpu_torch import native

    assert _run_threads(native.get_lib, n=8) == [None] * 8
    assert failing_gxx.read_text().count("call") == 1
