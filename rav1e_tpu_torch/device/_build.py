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
import threading
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
# one build per process, whichever thread comes first
_lock = threading.Lock()
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


class CdefArgs(ctypes.Structure):
    """The arguments of csrc/cdef.cu's kernels (``R1tCdefArgs``, field for
    field): the planes' grids and outputs, the per-cell maps, the geometry
    and the candidate strength lists."""

    _fields_ = [
        ("rec", ctypes.c_void_p * 3), ("src", ctypes.c_void_p * 3),
        ("out", ctypes.c_void_p * 3), ("filt", ctypes.c_void_p),
        ("dirs", ctypes.c_void_p), ("var", ctypes.c_void_p),
        ("sse", ctypes.c_void_p), ("idx", ctypes.c_void_p),
        ("ys", ctypes.c_int * 3), ("xs", ctypes.c_int * 3),
        ("vh", ctypes.c_int * 3), ("vw", ctypes.c_int * 3),
        *((n, ctypes.c_int) for n in (
            "nplanes", "nby", "nbx", "sb_rows", "sb_cols", "crop_w", "crop_h",
            "damping", "bd", "ncand")),
        ("y_str", ctypes.c_int * 4), ("uv_str", ctypes.c_int * 4),
    ]


_c = ctypes
# argument types of the library's C functions; each returns an int (a CUDA
# error code) but r1t_error_string
SIGNATURES = {
    "r1t_satd8": [_c.c_void_p, _c.c_void_p, _c.c_longlong, _c.c_int, _c.c_int,
                  _c.c_void_p],
    "r1t_grid_search": [*[_c.c_void_p] * 7, *[_c.c_int] * 9, _c.c_void_p],
    "r1t_cdef_dirs": [_c.POINTER(CdefArgs), _c.c_int, _c.c_void_p],
    "r1t_cdef_search": [_c.POINTER(CdefArgs), _c.c_int, _c.c_void_p],
    "r1t_cdef_apply": [_c.POINTER(CdefArgs), _c.c_int, _c.c_void_p],
    "r1t_deblock_edges": [*[_c.c_void_p] * 4, *[_c.c_int] * 7, _c.c_void_p],
    "r1t_fp_downsample": [*[_c.c_void_p] * 2, *[_c.c_int] * 4, _c.c_void_p],
    "r1t_fp_scene_sums": [*[_c.c_void_p] * 4, *[_c.c_int] * 5, _c.c_void_p],
    "r1t_fp_la_intra": [*[_c.c_void_p] * 2, *[_c.c_int] * 5, _c.c_void_p],
    "r1t_fp_la_motion": [*[_c.c_void_p] * 4, *[_c.c_int] * 5, _c.c_void_p],
    "r1t_fp_stream_create": [_c.POINTER(_c.c_void_p), _c.c_int],
    "r1t_fp_upload": [*[_c.c_void_p] * 2, _c.c_longlong, _c.c_int,
                      _c.c_void_p],
    "r1t_fp_scene": [*[_c.c_void_p] * 6, *[_c.c_int] * 6, _c.c_void_p],
    "r1t_fp_sync": [_c.c_void_p],
}


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(so, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        so.r1t_error_string.argtypes = [ctypes.c_int]
        so.r1t_error_string.restype = ctypes.c_char_p
        _lib = so
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = lib().r1t_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
