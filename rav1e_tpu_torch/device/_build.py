"""Build the port's CUDA kernels from ``csrc/*.cu`` at first use and load them.

``nvcc`` compiles every source under ``rav1e_tpu_torch/csrc`` into one shared
library with a plain C interface, ``build/rav1e_tpu_torch/libr1t_kernels.so``
at the repository root, keyed by a hash of the sources and flags (as
``native/librav1e_tpu_ec.so.hash`` is for the host coder).  It is loaded with
``ctypes``.  When ``nvcc`` is missing or the build fails, :func:`lib` raises
with the compiler's output: there is no fallback, since a CUDA tensor that
reaches a kernel wrapper must run the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "rav1e_tpu_torch"
LIB_PATH = BUILD_DIR / "libr1t_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None
# nvcc's and ptxas's report of the last build in this process (registers,
# shared memory and spills per kernel); empty when the cached library was
# loaded
build_log = ""


def sources():
    return sorted(CSRC.glob("*.cu"))


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.exists():
            exe = str(cand)
    if exe is None:
        raise RuntimeError(
            "nvcc not found: rav1e_tpu_torch builds its CUDA kernels from "
            f"{CSRC} at first use and needs the CUDA toolkit (put nvcc on "
            "PATH or set CUDA_HOME)"
        )
    return exe


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists."""
    global build_log
    srcs = sources()
    digest = _digest(srcs)
    stamp = LIB_PATH.with_name(LIB_PATH.name + ".hash")
    if LIB_PATH.exists() and stamp.exists() and stamp.read_text() == digest:
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, LIB_PATH)
    stamp.write_text(digest)
    build_log = proc.stdout + proc.stderr
    return LIB_PATH


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        c = ctypes
        so = c.CDLL(str(build()))
        so.r1t_satd8.argtypes = [
            c.c_void_p, c.c_void_p, c.c_longlong, c.c_int, c.c_int, c.c_void_p,
        ]
        so.r1t_satd8.restype = c.c_int
        so.r1t_sad_grid.argtypes = [
            c.c_void_p, c.c_void_p, c.c_void_p, c.c_int, c.c_int, c.c_int,
            c.c_int, c.c_int, c.c_void_p,
        ]
        so.r1t_sad_grid.restype = c.c_int
        so.r1t_error_string.argtypes = [c.c_int]
        so.r1t_error_string.restype = c.c_char_p
        _lib = so
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = lib().r1t_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
