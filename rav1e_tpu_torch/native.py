"""ctypes binding for the native host entropy coder (native/ec.cc).

Builds the shared library from the repository's ``native/`` sources on
first use (g++ -O3; cached under ``build/rav1e_tpu_torch/``).  Falls back
cleanly: callers check ``available()`` and keep the pure-Python path when
the toolchain is missing.  A context on a CUDA device does not: it calls
:func:`require_lib`, which raises with g++'s output, since the device chain
runs only with the library and a quiet fallback would hide it.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_ROOT = Path(__file__).resolve().parent.parent
_SRCS = [
    _ROOT / "native" / "ec.cc",
    _ROOT / "native" / "itx.cc",
    _ROOT / "native" / "enc.cc",
    _ROOT / "native" / "lrf.cc",
    _ROOT / "native" / "tile.cc",
]
# headers/includes that must participate in the rebuild hash
_HDRS = [
    _ROOT / "native" / "tile_intra.inc",
    _ROOT / "native" / "tile_code.inc",
    _ROOT / "native" / "tile_block.inc",
    _ROOT / "native" / "tile_deblock.inc",
]
# the port builds its own copy of the library from the shared sources, under
# build/ so that it never races the reference's loader for one file
_LIB = _ROOT / "build" / "rav1e_tpu_torch" / "librav1e_tpu_ec.so"

_lib: Optional[ctypes.CDLL] = None
_tried = False
# why the library is missing: g++'s output of a failed build, or the load
# error; None while nothing failed
_error: Optional[str] = None
# one build and one binding per process, whichever thread comes first (a
# thread that arrives meanwhile waits for its result)
_lock = threading.RLock()


_HASH = _LIB.with_suffix(".so.hash")


def _src_hash() -> str:
    import hashlib

    h = hashlib.sha256()
    for s in _SRCS + _HDRS:
        h.update(s.read_bytes())
    return h.hexdigest()


def _build(digest: str) -> bool:
    global _error
    # each process builds into its own file and renames it into place, so
    # concurrent test workers never load a half-written library
    tmp = _LIB.with_name(f"{_LIB.name}.{os.getpid()}.tmp")
    cmd = (["g++", "-O3", "-march=native", "-shared", "-fPIC"]
           + [str(s) for s in _SRCS] + ["-o", str(tmp)])
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, _LIB)
        hash_tmp = _HASH.with_name(f"{_HASH.name}.{os.getpid()}.tmp")
        hash_tmp.write_text(digest)
        os.replace(hash_tmp, _HASH)
        return True
    except Exception as e:
        tmp.unlink(missing_ok=True)
        out = getattr(e, "stderr", None) or b""
        if isinstance(out, bytes):
            out = out.decode(errors="replace")
        _error = f"{' '.join(cmd)}\n{e}\n{out}"
        return False


@contextlib.contextmanager
def _build_lock():
    """Hold a lock on a file beside the library: processes that start
    together (test workers, GOP-parallel encoders) build it one at a time,
    and the later ones find it built.  Where the directory cannot be
    written there is nothing to lock, and the build's own error is
    reported."""
    try:
        _LIB.parent.mkdir(parents=True, exist_ok=True)
        f = open(_LIB.with_name(f"{_LIB.name}.lock"), "w")
    except OSError:
        yield
        return
    with f:
        fcntl.flock(f, fcntl.LOCK_EX)
        yield


def get_lib() -> Optional[ctypes.CDLL]:
    if _lib is not None:
        return _lib
    with _lock:
        return _get_lib_locked()


def require_lib() -> ctypes.CDLL:
    """The library, or RuntimeError with the reason it is missing (g++'s
    output when the build failed)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(
            "rav1e_tpu_torch: the native host coder did not build or load, "
            "and a context on a CUDA device needs it (the device chain runs "
            f"only with it):\n{_error}"
        )
    return lib


def _get_lib_locked() -> Optional[ctypes.CDLL]:
    global _lib, _tried, _error
    if _lib is not None or _tried:
        return _lib
    _tried = True
    # Rebuild keyed on source-content hash: mtimes are unreliable after a
    # git checkout, and a stale binary built on another microarchitecture
    # (-march=native) must never be loaded.
    digest = _src_hash()
    with _build_lock():
        stale = (
            not _LIB.exists()
            or not _HASH.exists()
            or _HASH.read_text().strip() != digest
        )
        built = not stale or _build(digest)
    if not built:
        import sys

        print(
            "rav1e_tpu_torch: native library build FAILED -- falling back "
            "to the (much slower) pure-python paths. Run "
            "`g++ -O3 -march=native -shared -fPIC native/ec.cc native/itx.cc "
            "native/enc.cc native/lrf.cc native/tile.cc -o "
            "build/rav1e_tpu_torch/librav1e_tpu_ec.so` to see the error.",
            file=sys.stderr,
        )
        return None
    try:
        lib = ctypes.CDLL(str(_LIB))
        _bind_symbols(lib)
    except (OSError, AttributeError) as e:
        # missing symbol (stale binary that somehow passed the hash check)
        # or unloadable library: fall back to the pure-Python paths
        _error = f"{_LIB}: {e}"
        return None
    _load_itx_programs(lib)
    _load_subpel_filters(lib)
    _lib = lib
    return _lib


def _bind_symbols(lib) -> None:
    c = ctypes
    lib.ectx_new.restype = c.c_void_p
    lib.ectx_free.argtypes = [c.c_void_p]
    lib.ectx_symbol_update.argtypes = [c.c_void_p, c.c_int, c.c_void_p, c.c_int]
    lib.ectx_symbol.argtypes = [c.c_void_p, c.c_int, c.c_void_p, c.c_int]
    lib.ectx_bit.argtypes = [c.c_void_p, c.c_int]
    lib.ectx_literal.argtypes = [c.c_void_p, c.c_int, c.c_uint32]
    lib.ectx_golomb.argtypes = [c.c_void_p, c.c_uint32]
    lib.ectx_stream_bytes.argtypes = [c.c_void_p]
    lib.ectx_stream_bytes.restype = c.c_long
    lib.ectx_rng.argtypes = [c.c_void_p]
    lib.ectx_cnt.argtypes = [c.c_void_p]
    lib.ectx_checkpoint.argtypes = [c.c_void_p, c.POINTER(c.c_long)]
    lib.ectx_rollback.argtypes = [c.c_void_p, c.POINTER(c.c_long)]
    lib.ectx_done.argtypes = [c.c_void_p, c.c_void_p, c.c_long]
    lib.ectx_done.restype = c.c_long
    lib.ectx_write_coeffs.argtypes = [
        c.c_void_p, c.c_void_p, c.c_int, c.c_int, c.c_int, c.c_int, c.c_int,
        c.c_void_p, c.c_int, c.c_int, c.c_int,
        c.c_void_p, c.c_int, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
        c.c_void_p,
    ]
    lib.ectx_write_coeffs.restype = c.c_int
    lib.ectx_count_coeffs.argtypes = [
        c.c_void_p, c.c_void_p, c.c_int, c.c_int, c.c_int, c.c_int, c.c_int,
        c.c_void_p, c.c_int, c.c_int, c.c_int,
        c.c_void_p, c.c_int, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
        c.c_void_p,
    ]
    lib.ectx_count_coeffs.restype = c.c_int
    lib.enc_sgr_decide_unit.argtypes = [
        c.c_void_p, c.c_long, c.c_void_p, c.c_long, c.c_void_p, c.c_long,
        c.c_int, c.c_long, c.c_int, c.c_void_p, c.c_int, c.c_long, c.c_long,
        c.c_int, c.c_void_p, c.c_int, c.c_void_p,
    ]
    lib.enc_sgr_decide_unit.restype = c.c_longlong
    lib.enc_sgr_decide_plane.argtypes = [
        c.c_void_p, c.c_long, c.c_void_p, c.c_long, c.c_void_p, c.c_long,
        c.c_int, c.c_long, c.c_long, c.c_int, c.c_void_p, c.c_void_p,
        c.c_int, c.c_long, c.c_int, c.c_int, c.c_void_p, c.c_int,
        c.c_void_p, c.c_void_p,
    ]
    lib.enc_lookahead_me.argtypes = [
        c.c_void_p, c.c_long, c.c_void_p, c.c_long, c.c_int, c.c_long,
        c.c_long, c.c_void_p, c.c_void_p, c.c_void_p, c.c_int,
    ]
    lib.itx_load_program.argtypes = [
        c.c_int, c.c_int, c.c_int, c.c_void_p, c.c_void_p, c.c_void_p,
        c.c_void_p, c.c_void_p, c.c_void_p, c.c_int, c.c_void_p,
    ]
    lib.itx_inverse_add.argtypes = [
        c.c_void_p, c.c_void_p, c.c_void_p, c.c_int, c.c_int, c.c_int,
        c.c_int, c.c_int, c.c_int, c.c_int, c.c_int,
    ]
    lib.itx_dequant_recon.argtypes = [
        c.c_void_p, c.c_int, c.c_int, c.c_long, c.c_long, c.c_int,
        c.c_void_p, c.c_long, c.c_int, c.c_long, c.c_long, c.c_int,
        c.c_int, c.c_int, c.c_int, c.c_int, c.c_int,
    ]
    # encoder hot loops (native/enc.cc)
    lib.enc_set_subpel_filters.argtypes = [c.c_void_p]
    lib.enc_put_8tap.argtypes = [
        c.c_void_p, c.c_long, c.c_int, c.c_long, c.c_long, c.c_int, c.c_int,
        c.c_int, c.c_int, c.c_int, c.c_int, c.c_int, c.c_void_p,
    ]
    lib.enc_me_search.argtypes = [
        c.c_void_p, c.c_long, c.c_long, c.c_long, c.c_int, c.c_long, c.c_long,
        c.c_void_p, c.c_long, c.c_long, c.c_long, c.c_int, c.c_int, c.c_int,
        c.c_void_p, c.c_int, c.c_int, c.c_void_p,
    ]
    lib.enc_me_search.restype = c.c_long
    lib.enc_me_search_satd.argtypes = lib.enc_me_search.argtypes
    lib.enc_me_search_satd.restype = c.c_long
    lib.enc_me_set_method.argtypes = [c.c_int, c.c_int]
    lib.enc_prep_8tap.argtypes = lib.enc_put_8tap.argtypes
    lib.enc_mc_avg.argtypes = [c.c_void_p, c.c_void_p, c.c_int, c.c_int, c.c_void_p]
    lib.enc_quantize.argtypes = [
        c.c_void_p, c.c_int, c.c_int, c.c_int, c.c_int, c.c_void_p, c.c_int,
        c.c_long, c.c_long, c.c_long, c.c_long, c.c_long, c.c_long, c.c_void_p,
    ]
    lib.enc_quantize.restype = c.c_int
    lib.enc_register_fwd.argtypes = [
        c.c_int, c.c_int, c.c_void_p, c.c_int, c.c_void_p, c.c_int,
    ]
    lib.enc_fwd_quant.argtypes = [
        c.c_void_p, c.c_long, c.c_void_p, c.c_long, c.c_int, c.c_long,
        c.c_long, c.c_int, c.c_int, c.c_int, c.c_int, c.c_void_p, c.c_int,
        c.c_long, c.c_long, c.c_long, c.c_long, c.c_long, c.c_long, c.c_void_p,
    ]
    lib.enc_fwd_quant.restype = c.c_int
    lib.enc_cdef_dirs.argtypes = [
        c.c_void_p, c.c_long, c.c_int, c.c_int, c.c_void_p, c.c_void_p,
        c.c_int, c.c_void_p, c.c_void_p,
    ]
    lib.enc_cdef_dir.argtypes = [
        c.c_void_p, c.c_long, c.c_int, c.c_long, c.c_long, c.c_int,
        c.c_void_p, c.c_void_p,
    ]
    lib.enc_cdef_filter.argtypes = [
        c.c_void_p, c.c_long, c.c_int, c.c_void_p, c.c_long, c.c_int,
        c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_int, c.c_int,
        c.c_int, c.c_int, c.c_int, c.c_void_p, c.c_void_p, c.c_void_p,
        c.c_void_p,
    ]
    lib.enc_inter_costs_8x8.argtypes = [
        c.c_void_p, c.c_long, c.c_void_p, c.c_long, c.c_int, c.c_long,
        c.c_long, c.c_void_p, c.c_long, c.c_long, c.c_int, c.c_void_p,
    ]
    lib.tile_pred_directional.argtypes = [
        c.c_void_p, c.c_long, c.c_void_p, c.c_long, c.c_long, c.c_int,
        c.c_int, c.c_int, c.c_int, c.c_int, c.c_int, c.c_void_p,
    ]
    lib.enc_la_intra_costs.argtypes = [
        c.c_void_p, c.c_long, c.c_int, c.c_long, c.c_long, c.c_int,
        c.c_void_p,
    ]
    lib.enc_propagate_importance.argtypes = [
        c.c_void_p, c.c_long, c.c_long, c.c_void_p, c.c_long, c.c_long,
        c.c_void_p, c.c_long, c.c_long,
    ]
    lib.enc_seg_stats.argtypes = [
        c.c_void_p, c.c_long, c.c_void_p, c.c_long, c.c_int, c.c_long,
        c.c_long, c.c_void_p, c.c_void_p, c.c_void_p,
    ]
    lib.enc_cdef_rdo.argtypes = [
        c.c_int, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_int,
        c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_int, c.c_void_p,
        c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
        c.c_void_p, c.c_void_p, c.c_void_p, c.c_int, c.c_void_p, c.c_void_p,
        c.c_int, c.c_int, c.c_long, c.c_void_p,
    ]
    lib.tile_perf.argtypes = [c.c_void_p]
    lib.tile_deblock_plane.argtypes = [
        c.c_void_p, c.c_void_p, c.c_long, c.c_int, c.c_void_p, c.c_void_p,
        c.c_int, c.c_int, c.c_int, c.c_long, c.c_long, c.c_int, c.c_int,
        c.c_int,
    ]
    lib.tile_deblock_search.argtypes = [
        c.c_int, c.c_void_p, c.c_long, c.c_int, c.c_long, c.c_long, c.c_long,
        c.c_void_p, c.c_long, c.c_void_p, c.c_void_p, c.c_int, c.c_int,
        c.c_long, c.c_long, c.c_int,
    ]
    lib.tile_deblock_search.restype = c.c_int
    lib.enc_sgr_apply_stripe.argtypes = [
        c.c_void_p, c.c_long, c.c_void_p, c.c_long, c.c_int, c.c_void_p,
        c.c_long, c.c_long, c.c_long, c.c_int, c.c_int, c.c_long, c.c_long,
        c.c_int, c.c_long, c.c_long, c.c_int, c.c_int,
    ]
    lib.enc_wiener_apply_stripe.argtypes = [
        c.c_void_p, c.c_void_p, c.c_long, c.c_void_p, c.c_long, c.c_int,
        c.c_void_p, c.c_long, c.c_long, c.c_long, c.c_int, c.c_int, c.c_long,
        c.c_long, c.c_int,
    ]


def _load_subpel_filters(lib) -> None:
    import numpy as np

    from rav1e_tpu_torch.ops.mc import SUBPEL_FILTERS

    arr = np.ascontiguousarray(SUBPEL_FILTERS, dtype=np.int32)
    assert arr.shape == (6, 16, 8)
    lib.enc_set_subpel_filters(arr.ctypes.data)


def _load_itx_programs(lib) -> None:
    import numpy as np

    from rav1e_tpu_torch import tables
    from rav1e_tpu_torch.tx import TxType1D

    families = {
        TxType1D.DCT: ("dct", [4, 8, 16, 32, 64], 0),
        TxType1D.ADST: ("adst", [4, 8, 16], 1),
        TxType1D.FLIPADST: ("flipadst", [4, 8, 16], 2),
    }
    for _, (name, sizes, fam_id) in families.items():
        for n in sizes:
            p = tables.inv_tx_program(f"{name}{n}")
            kind = np.ascontiguousarray(p["kind"], dtype=np.int8)
            a = np.ascontiguousarray(p["a"], dtype=np.int32)
            b = np.ascontiguousarray(p["b"], dtype=np.int32)
            w0 = np.ascontiguousarray(p["w0"], dtype=np.int32)
            w1 = np.ascontiguousarray(p["w1"], dtype=np.int32)
            aux = np.ascontiguousarray(p["aux"], dtype=np.int32)
            out = np.ascontiguousarray(p["out"], dtype=np.int32)
            lib.itx_load_program(
                fam_id, n, len(kind), kind.ctypes.data, a.ctypes.data,
                b.ctypes.data, w0.ctypes.data, w1.ctypes.data,
                aux.ctypes.data, len(out), out.ctypes.data,
            )


def itx_inverse_add_native(coeffs, pred, tx_size, tx_type, bd: int):
    """Native 2-D inverse + add for a single (H, W) numpy block."""
    import numpy as np

    from rav1e_tpu_torch.tx import (
        INV_INTERMEDIATE_SHIFTS,
        TxType,
        TxType1D,
        get_1d_tx_types,
    )

    lib = get_lib()
    vert, horiz = get_1d_tx_types(tx_type)
    h, w = tx_size.height, tx_size.width
    c = np.ascontiguousarray(coeffs, dtype=np.int32)
    p = np.ascontiguousarray(pred, dtype=np.int32)
    out = np.empty((h, w), dtype=np.int32)
    lib.itx_inverse_add(
        c.ctypes.data, p.ctypes.data, out.ctypes.data, w, h,
        int(vert), int(horiz), INV_INTERMEDIATE_SHIFTS[tx_size],
        int(tx_size.is_rect()), int(tx_type == TxType.WHT_WHT), bd,
    )
    return out


import functools


@functools.lru_cache(maxsize=4096)
def _dequant_recon_params(qindex, tx_size, tx_type, bd, dc_delta_q, ac_delta_q):
    from rav1e_tpu_torch import tables
    from rav1e_tpu_torch.tx import (
        INV_INTERMEDIATE_SHIFTS,
        TxType,
        get_1d_tx_types,
        get_log_tx_scale,
    )

    vert, horiz = get_1d_tx_types(tx_type)
    return (
        tx_size.width, tx_size.height,
        int(tables.dc_q(qindex, dc_delta_q, bd)),
        int(tables.ac_q(qindex, ac_delta_q, bd)),
        get_log_tx_scale(tx_size), int(vert), int(horiz),
        INV_INTERMEDIATE_SHIFTS[tx_size], int(tx_size.is_rect()),
        int(tx_type == TxType.WHT_WHT),
    )


def dequant_recon_native(
    qcoeffs, qindex: int, tx_size, tx_type, bd: int, rec_view, px: int, py: int,
    dc_delta_q: int = 0, ac_delta_q: int = 0,
) -> bool:
    """Fused dequant + inverse transform + recon add in place on the strided
    recon view.  Returns False when the native path is unavailable."""
    import numpy as np

    lib = get_lib()
    if lib is None or rec_view.itemsize not in (1, 2):
        return False
    w, h, dcq, acq, lts, vert, horiz, ishift, rect, wht = _dequant_recon_params(
        qindex, tx_size, tx_type, bd, dc_delta_q, ac_delta_q
    )
    q = np.ascontiguousarray(qcoeffs, dtype=np.int32)
    lib.itx_dequant_recon(
        q.ctypes.data, w, h, dcq, acq, lts,
        rec_view.ctypes.data, rec_view.strides[0] // rec_view.itemsize,
        rec_view.itemsize, px, py,
        vert, horiz, ishift, rect, wht, bd,
    )
    return True


_fwd_registered = set()


_fwd_static: dict = {}


def _fwd_static_args(tx_size, tx_type, lib):
    """Per-(tx_size, tx_type) invariants for enc_fwd_quant, computed once:
    (w, h, cw, ch, scan_array, ts_int, tt_int) or None for WHT."""
    import numpy as np

    from rav1e_tpu_torch.quantize import _scan_kind, _scan_u16
    from rav1e_tpu_torch.tx import TxType

    if tx_type == TxType.WHT_WHT:
        return None
    key = (int(tx_size), int(tx_type))
    with _lock:
        if key not in _fwd_registered:
            from rav1e_tpu_torch.ops.transforms import _fwd_matrices_int

            fv, fh = _fwd_matrices_int(tx_size, tx_type)
            fv32 = np.ascontiguousarray(fv, dtype=np.int32)
            fh32 = np.ascontiguousarray(fh, dtype=np.int32)
            lib.enc_register_fwd(
                key[0], key[1], fv32.ctypes.data, fv32.shape[0],
                fh32.ctypes.data, fh32.shape[0],
            )
            _fwd_registered.add(key)
    w, h = tx_size.width, tx_size.height
    cw, ch = min(w, 32), min(h, 32)
    scan16 = _scan_u16(cw, ch, _scan_kind(tx_type))
    return (w, h, cw, ch, scan16, scan16.ctypes.data, key[0], key[1])


def fwd_quant_native(src_view, rec_view, px, py, tx_size, tx_type, qc, bd):
    """Fused residual + integer forward transform + quantize in C
    (bit-exact with ops/transforms.forward_transform + quantize_block).
    Returns (qcoeffs, eob) or None when unavailable."""
    import numpy as np

    lib = get_lib()
    if lib is None or src_view.itemsize not in (1, 2):
        return None
    key = (tx_size, tx_type)
    st = _fwd_static.get(key, False)
    if st is False:
        st = _fwd_static_args(tx_size, tx_type, lib)
        _fwd_static[key] = st
    if st is None:  # WHT
        return None
    w, h, cw, ch, _scan_keep, scan_ptr, ts_i, tt_i = st
    q = np.zeros((h, w), dtype=np.int32)
    eob = lib.enc_fwd_quant(
        src_view.ctypes.data, src_view.strides[0] // src_view.itemsize,
        rec_view.ctypes.data, rec_view.strides[0] // rec_view.itemsize,
        src_view.itemsize, px, py, ts_i, tt_i, cw, ch,
        scan_ptr, qc.log_tx_scale, qc.dc_quant, qc.ac_quant,
        qc.dc_offset, qc.ac_offset0, qc.ac_offset1, qc.ac_offset_eob,
        q.ctypes.data,
    )
    if eob < 0:
        return None
    return q, eob


def available() -> bool:
    return get_lib() is not None


class NativeWriterEncoder:
    """Drop-in for ec.WriterEncoder backed by the C++ coder.

    Only the surface the final-emission pass uses (symbol_with_update via
    ContextWriter, bit/literal/golomb, done); RDO rate counting stays on the
    Python WriterCounter.
    """

    __slots__ = ("lib", "h")

    def __init__(self):
        self.lib = get_lib()
        assert self.lib is not None
        self.h = self.lib.ectx_new()

    def __del__(self):
        try:
            if self.h:
                self.lib.ectx_free(self.h)
                self.h = None
        except Exception:
            pass

    # symbol layer -----------------------------------------------------

    def symbol_update_row(self, s: int, arr, idx: tuple) -> None:
        """Code + adapt against the numpy CDF row arr[idx] in place."""
        row = arr[idx]
        n = row.shape[-1]
        self.lib.ectx_symbol_update(self.h, s, row.ctypes.data, n)

    def symbol(self, s: int, cdf) -> None:
        import numpy as np

        row = np.asarray(cdf, dtype=np.uint16)
        self.lib.ectx_symbol(self.h, s, row.ctypes.data, len(row))

    def bit(self, b: int) -> None:
        self.lib.ectx_bit(self.h, b)

    def literal(self, bits: int, v: int) -> None:
        self.lib.ectx_literal(self.h, bits, v)

    def write_golomb(self, level: int) -> None:
        self.lib.ectx_golomb(self.h, level)

    def stream_bits(self) -> int:
        return int(self.lib.ectx_stream_bytes(self.h)) * 8

    def tell(self) -> int:
        return self.stream_bits() + int(ctypes.c_int16(self.lib.ectx_cnt(self.h)).value) + 10

    def done(self) -> bytes:
        cap = int(self.lib.ectx_stream_bytes(self.h)) + 64
        buf = (ctypes.c_uint8 * cap)()
        n = self.lib.ectx_done(self.h, buf, cap)
        assert n >= 0
        return bytes(bytearray(buf)[:n])
