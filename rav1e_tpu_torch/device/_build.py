"""Build the port's CUDA kernels from ``csrc/*.cu`` at first use and load them.

``nvcc`` compiles every source under ``rav1e_tpu_torch/csrc`` (one process
per source, all started together) and links the objects into one shared
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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NVCC_TIMEOUT_S = 900

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
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pid = os.getpid()
    objs = [BUILD_DIR / f"{s.stem}.{pid}.o" for s in srcs]
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{pid}.tmp")
    # one nvcc per source, all at once, then one link
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
            for s, o in zip(srcs, objs)]
    procs = []
    try:
        for c in cmds:
            procs.append(subprocess.Popen(c, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
        logs = []
        for cmd, p in zip(cmds, procs):
            out, _ = p.communicate(timeout=NVCC_TIMEOUT_S)
            logs.append(_checked(cmd, p.returncode, out))
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              timeout=NVCC_TIMEOUT_S)
        logs.append(_checked(link, proc.returncode, proc.stdout))
        os.replace(tmp, LIB_PATH)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    stamp.write_text(digest)
    build_log = "".join(logs)
    return LIB_PATH


def _checked(cmd, returncode: int, output: str) -> str:
    if returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {returncode}:\n{' '.join(cmd)}\n"
            f"{output}"
        )
    return output


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
        so.r1t_grid_search.argtypes = [
            *[c.c_void_p] * 7, *[c.c_int] * 9, c.c_void_p,
        ]
        so.r1t_grid_search.restype = c.c_int
        so.r1t_error_string.argtypes = [c.c_int]
        so.r1t_error_string.restype = c.c_char_p
        _lib = so
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = lib().r1t_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
