"""ctypes binding for the native tile block-coding engine (native/tile.cc).

Given the device analysis decision maps, one call codes a whole tile's
symbol stream in C++ — the serial host half of the TPU design.  The Python
TileEncoder path remains the behavioral oracle: tests/test_native_tile.py
asserts byte-identical bitstreams between the two.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np

from rav1e_tpu_torch import native, tables
from rav1e_tpu_torch.api.util import EncoderStats, FrameType
from rav1e_tpu_torch.config import ChromaSampling
from rav1e_tpu_torch.partition import BlockSize
from rav1e_tpu_torch.quantize import _scan_u16
from rav1e_tpu_torch.tx import TxSize, TxType

c_int, c_long, c_ptr = ctypes.c_int, ctypes.c_long, ctypes.c_void_p


class PlaneDescC(ctypes.Structure):
    _fields_ = [
        ("data", c_ptr), ("stride", c_long), ("bytespp", c_int),
        ("pad", c_long), ("vis_w", c_long), ("vis_h", c_long),
        ("alloc_w", c_long), ("alloc_h", c_long),
    ]


class LrfPlaneC(ctypes.Structure):
    _fields_ = [
        ("lrf_type", c_int), ("cols", c_int), ("rows", c_int),
        ("sb_h_shift", c_int), ("sb_v_shift", c_int),
        ("sb_cols", c_int), ("sb_rows", c_int),
        ("kind", c_ptr), ("sgr_set", c_ptr), ("xqd", c_ptr), ("wiener", c_ptr),
    ]


class TileParamsC(ctypes.Structure):
    _fields_ = [
        ("mi_x0", c_int), ("mi_y0", c_int), ("mi_w", c_int), ("mi_h", c_int),
        ("frame_mi_cols", c_int), ("frame_mi_rows", c_int),
        ("xdec", c_int), ("ydec", c_int), ("nplanes", c_int),
        ("bit_depth", c_int),
        ("frame_type", c_int), ("is_inter_frame", c_int),
        ("base_q_idx", c_int), ("tx_mode_select", c_int),
        ("use_reduced_tx_set", c_int), ("enable_filter_intra", c_int),
        ("enable_intra_edge_filter", c_int), ("reference_mode_select", c_int),
        ("pr_min_log2", c_int), ("pr_max_log2", c_int),
        ("enable_inter_tx_split", c_int), ("use_satd_subpel", c_int),
        ("seg_enabled", c_int), ("seg_last_active", c_int),
        ("seg_map", c_ptr), ("seg_map_s", c_long),
        ("seg_qidx", c_ptr), ("seg_dcq", c_ptr), ("seg_acq", c_ptr),
        ("dev_size_log2", c_ptr), ("dev_s", c_long),
        ("dev_mode", c_ptr),
        ("dev_use_inter", c_ptr), ("dev_inter_s", c_long),
        ("cdef_bits", c_int), ("cdef_idx_map", c_ptr), ("cdef_map_s", c_long),
        ("src", PlaneDescC * 3), ("rec", PlaneDescC * 3),
        ("have_ref0", c_int), ("have_ref1", c_int),
        ("ref0", PlaneDescC * 3), ("ref1", PlaneDescC * 3),
        ("me_field0", c_ptr), ("me_f0_h", c_long), ("me_f0_w", c_long),
        ("me_field1", c_ptr), ("me_f1_h", c_long), ("me_f1_w", c_long),
        ("prev_mvs", c_ptr), ("prev_mvs_s", c_long),
        ("dev_mv0", c_ptr), ("dev_mv1", c_ptr),
        ("dev_mv_h", c_long), ("dev_mv_w", c_long),
        ("lrf_present", c_int), ("lrf", LrfPlaneC * 3),
        ("stats", c_ptr),
        ("reuse", c_int),
        ("reuse_is_inter", c_ptr), ("reuse_is_inter_s", c_long),
        ("reuse_ref", c_ptr), ("reuse_ref_s", c_long),
        ("reuse_mv", c_ptr), ("reuse_mv_s", c_long),
        ("skip_mode_present", c_int),
        ("coeff_log_mode", c_int),
        ("coeff_log", c_ptr), ("coeff_log_cap", c_long),
        ("coeff_log_len", c_ptr),
        ("have_ref2", c_int), ("ref2", PlaneDescC * 3),
        ("dev_mv2", c_ptr),
    ]


# must match the CdfId enum in native/tile.cc
CDF_ORDER = [
    "partition_w8_cdf", "partition_cdf", "kf_y_cdf", "y_mode_cdf",
    "uv_mode_cdf", "uv_mode_cfl_cdf", "cfl_sign_cdf", "cfl_alpha_cdf",
    "newmv_cdf", "zeromv_cdf", "refmv_cdf", "drl_cdfs",
    "intra_tx_2_cdf", "intra_tx_1_cdf", "inter_tx_3_cdf", "inter_tx_2_cdf",
    "inter_tx_1_cdf", "tx_size_8x8_cdf", "tx_size_cdf", "txfm_partition_cdf",
    "skip_cdfs", "intra_inter_cdfs", "angle_delta_cdf", "filter_intra_cdfs",
    "spatial_segmentation_cdfs", "comp_mode_cdf", "comp_ref_type_cdf",
    "comp_ref_cdf", "comp_bwd_ref_cdf", "single_ref_cdfs",
    "compound_mode_cdf", "nmv_joints_cdf", "nmv_sign_cdf", "nmv_classes_cdf",
    "nmv_class0_cdf", "nmv_bits_cdf", "nmv_class0_fp_cdf", "nmv_fp_cdf",
    "nmv_class0_hp_cdf", "nmv_hp_cdf", "txb_skip_cdf", "dc_sign_cdf",
    "eob_extra_cdf", "eob_flag_cdf16", "eob_flag_cdf32", "eob_flag_cdf64",
    "eob_flag_cdf128", "eob_flag_cdf256", "eob_flag_cdf512",
    "eob_flag_cdf1024", "coeff_base_eob_cdf", "coeff_base_cdf",
    "coeff_br_cdf", "lrf_switchable_cdf", "lrf_sgrproj_cdf", "lrf_wiener_cdf",
    "skip_mode_cdfs",
]

_bound = False
_keepalive: list = []


def _bind(lib) -> None:
    global _bound
    if _bound:
        return
    lib.tile_register_scan.argtypes = [c_int, c_ptr]
    lib.tile_encode.argtypes = [
        ctypes.POINTER(TileParamsC), c_ptr, c_ptr, c_ptr, c_ptr, c_ptr,
        c_ptr, c_ptr, c_ptr, c_long,
    ]
    lib.tile_encode.restype = c_long

    # scans (default kind; V_/H_ 1-D tx types are never coded on this path)
    for t in TxSize:
        cw, ch = min(t.width, 32), min(t.height, 32)
        scan = _scan_u16(cw, ch, "default")
        _keepalive.append(scan)
        lib.tile_register_scan(int(t), scan.ctypes.data)

    # forward matrices: DCT everywhere + the chroma mode-preferred types
    from rav1e_tpu_torch.native import _fwd_registered
    from rav1e_tpu_torch.ops.transforms import _fwd_matrices_int

    def reg(tx_size, tx_type):
        key = (int(tx_size), int(tx_type))
        if key in _fwd_registered:
            return
        fv, fh = _fwd_matrices_int(tx_size, tx_type)
        fv32 = np.ascontiguousarray(fv, dtype=np.int32)
        fh32 = np.ascontiguousarray(fh, dtype=np.int32)
        _keepalive.extend([fv32, fh32])
        lib.enc_register_fwd(
            int(tx_size), int(tx_type), fv32.ctypes.data, fv32.shape[0],
            fh32.ctypes.data, fh32.shape[0],
        )
        _fwd_registered.add(key)

    for t in TxSize:
        reg(t, TxType.DCT_DCT)
        # chroma mode-preferred types are only used when both dims < 32
        # (write_tx_blocks forces DCT otherwise); ADST 1-D exists up to 16
        if t.width <= 16 and t.height <= 16:
            for tt in (TxType.ADST_DCT, TxType.DCT_ADST, TxType.ADST_ADST):
                reg(t, tt)
    _bound = True


@functools.lru_cache(None)
def _avail_tables():
    """(22, 32, 32) uint8 top-right / bottom-left availability bit tables
    (ops/availability.py, precomputed once for the C++ coder)."""
    from rav1e_tpu_torch.ops.availability import _has_bl_bit, _has_tr_bit

    tr = np.zeros((22, 32, 32), dtype=np.uint8)
    bl = np.zeros((22, 32, 32), dtype=np.uint8)
    for bs in BlockSize:
        bw, bh = bs.width_mi, bs.height_mi
        if bw > 32 or bh > 32:
            continue
        for r in range(32 // bh):
            for c in range(32 // bw):
                tr[int(bs), r, c] = _has_tr_bit(bw, bh, r, c)
                bl[int(bs), r, c] = _has_bl_bit(bw, bh, r, c)
    return tr, bl


def _plane_desc(plane) -> PlaneDescC:
    d = PlaneDescC()
    arr = plane.data
    d.data = arr.ctypes.data
    d.stride = arr.strides[0] // arr.itemsize
    d.bytespp = arr.itemsize
    d.pad = plane.cfg.pad
    d.vis_w = plane.cfg.width
    d.vis_h = plane.cfg.height
    d.alloc_w = plane.cfg.alloc_width
    d.alloc_h = plane.cfg.alloc_height
    return d


def _cdf_arrays(fc, keep):
    n = len(CDF_ORDER)
    ptrs = np.zeros(n, dtype=np.int64)
    strides = np.zeros((n, 3), dtype=np.int64)
    last = np.zeros(n, dtype=np.int32)
    for i, name in enumerate(CDF_ORDER):
        arr = getattr(fc, name)
        assert arr.dtype == np.uint16 and arr.flags["C_CONTIGUOUS"], name
        ptrs[i] = arr.ctypes.data
        last[i] = arr.shape[-1]
        es = [s // 2 for s in arr.strides[:-1]]
        for j, s in enumerate(es[:3]):
            strides[i, j] = s
        keep.append(arr)
    keep.extend([ptrs, strides, last])
    return ptrs, strides, last


def encode_tile_native(te) -> Optional[tuple]:
    """Run the C++ tile coder for a TileEncoder.  Returns (payload_bytes,
    EncoderStats) or None when ineligible / failed (caller falls back)."""
    from rav1e_tpu_torch.utils import desync

    fi = te.fi
    if fi.device_maps is None or desync.enabled():
        return None
    if te.replay is not None and len(te.replay) > 0:
        return None
    lib = native.get_lib()
    if lib is None or not hasattr(lib, "tile_encode"):
        return None
    _bind(lib)

    keep: list = []
    p = TileParamsC()
    p.mi_x0, p.mi_y0 = te.mi_x0, te.mi_y0
    p.mi_w, p.mi_h = te.mi_w, te.mi_h
    p.frame_mi_cols, p.frame_mi_rows = fi.mi_cols, fi.mi_rows
    cs = fi.seq.chroma_sampling
    p.xdec, p.ydec = te.xdec, te.ydec
    p.nplanes = 1 if cs == ChromaSampling.Cs400 else 3
    p.bit_depth = fi.bit_depth
    p.frame_type = 0 if fi.frame_type == FrameType.KEY else 1
    p.is_inter_frame = int(fi.is_inter_frame)
    p.base_q_idx = fi.base_q_idx
    p.tx_mode_select = int(fi.tx_mode_select)
    p.use_reduced_tx_set = int(fi.use_reduced_tx_set)
    p.enable_filter_intra = int(fi.seq.enable_filter_intra)
    p.enable_intra_edge_filter = int(fi.seq.enable_intra_edge_filter)
    p.reference_mode_select = int(fi.ref_frame_bwd is not None)
    p.skip_mode_present = int(getattr(fi, "skip_mode_present", False))
    pr = te.speed.partition.partition_range
    p.pr_min_log2, p.pr_max_log2 = pr.min_log2, pr.max_log2
    p.enable_inter_tx_split = int(te.speed.transform.enable_inter_tx_split)
    p.use_satd_subpel = int(te.speed.motion.use_satd_subpel)

    # segmentation
    if fi.seg is not None:
        p.seg_enabled = 1
        p.seg_last_active = fi.seg.last_active_segid
        seg_map = np.ascontiguousarray(fi.seg.seg_map, dtype=np.uint8)
        keep.append(seg_map)
        p.seg_map = seg_map.ctypes.data
        p.seg_map_s = seg_map.strides[0]
        qidx = np.array(
            [fi.seg.qidx(fi.base_q_idx, s) for s in range(8)], dtype=np.int32
        )
    else:
        p.seg_enabled = 0
        p.seg_last_active = 0
        qidx = np.full(8, fi.base_q_idx, dtype=np.int32)
    # per (segment, plane): qidx(seg) + the frame's per-plane delta
    # (rate.rs:510 chroma_offset path)
    dcq = np.array(
        [[tables.dc_q(int(q), fi.dc_delta_q[pl], fi.bit_depth)
          for pl in range(3)] for q in qidx], dtype=np.int32
    )
    acq = np.array(
        [[tables.ac_q(int(q), fi.ac_delta_q[pl], fi.bit_depth)
          for pl in range(3)] for q in qidx], dtype=np.int32
    )
    qidx32 = np.ascontiguousarray(qidx)
    keep.extend([qidx32, dcq, acq])
    p.seg_qidx = qidx32.ctypes.data
    p.seg_dcq = dcq.ctypes.data
    p.seg_acq = acq.ctypes.data

    # device maps
    dm = fi.device_maps
    size_map = np.ascontiguousarray(dm.size_log2, dtype=np.int32)
    mode_map = np.ascontiguousarray(dm.mode, dtype=np.int32)
    inter_map = np.ascontiguousarray(dm.use_inter).view(np.uint8)
    keep.extend([size_map, mode_map, inter_map])
    p.dev_size_log2 = size_map.ctypes.data
    p.dev_s = size_map.shape[1]
    p.dev_mode = mode_map.ctypes.data
    p.dev_use_inter = inter_map.ctypes.data
    p.dev_inter_s = inter_map.shape[1]

    # cdef
    p.cdef_bits = te.cdef_bits
    if te.cdef_bits and te.cdef_idx_map is not None:
        cmap = np.ascontiguousarray(te.cdef_idx_map, dtype=np.int32)
        keep.append(cmap)
        p.cdef_idx_map = cmap.ctypes.data
        p.cdef_map_s = cmap.shape[1]

    # planes
    for i in range(3):
        src_pl = te.src.planes[i] if i < len(te.src.planes) else te.src.planes[0]
        rec_pl = te.rec.planes[i] if i < len(te.rec.planes) else te.rec.planes[0]
        p.src[i] = _plane_desc(src_pl)
        p.rec[i] = _plane_desc(rec_pl)
    p.have_ref0 = int(fi.ref_frame is not None)
    p.have_ref1 = int(fi.ref_frame_bwd is not None)
    # chain replay (reuse + coeff log): select_inter returns from the reuse
    # grids and MC/recon are skipped, so the reference planes are never
    # dereferenced — leave the descriptors null rather than materializing
    # device-resident reconstructions (tile_block.inc select_inter :678)
    chain_replay = (
        getattr(te, "reuse_blocks", None) is not None
        and getattr(te, "coeff_log_in", None) is not None
    )
    if not chain_replay and fi.ref_frame is not None:
        for i in range(3):
            pl = fi.ref_frame.planes[i] if i < len(fi.ref_frame.planes) else fi.ref_frame.planes[0]
            p.ref0[i] = _plane_desc(pl)
    if not chain_replay and fi.ref_frame_bwd is not None:
        for i in range(3):
            pl = fi.ref_frame_bwd.planes[i] if i < len(fi.ref_frame_bwd.planes) else fi.ref_frame_bwd.planes[0]
            p.ref1[i] = _plane_desc(pl)
    p.have_ref2 = int(fi.ref_frame_bwd2 is not None)
    if not chain_replay and fi.ref_frame_bwd2 is not None:
        for i in range(3):
            pl = (fi.ref_frame_bwd2.planes[i]
                  if i < len(fi.ref_frame_bwd2.planes)
                  else fi.ref_frame_bwd2.planes[0])
            p.ref2[i] = _plane_desc(pl)

    # ME fields + temporal MVs
    if fi.me_fields is not None:
        from rav1e_tpu_torch.context.mv import ALTREF_FRAME, LAST_FRAME

        mf0 = fi.me_fields.get(LAST_FRAME)
        if mf0 is not None:
            mf0 = np.ascontiguousarray(mf0, dtype=np.int32)
            keep.append(mf0)
            p.me_field0 = mf0.ctypes.data
            p.me_f0_h, p.me_f0_w = mf0.shape[0], mf0.shape[1]
        mf1 = fi.me_fields.get(ALTREF_FRAME)
        if mf1 is not None:
            mf1 = np.ascontiguousarray(mf1, dtype=np.int32)
            keep.append(mf1)
            p.me_field1 = mf1.ctypes.data
            p.me_f1_h, p.me_f1_w = mf1.shape[0], mf1.shape[1]
    if fi.prev_mvs is not None:
        pm = np.ascontiguousarray(fi.prev_mvs, dtype=np.int16)
        keep.append(pm)
        p.prev_mvs = pm.ctypes.data
        p.prev_mvs_s = pm.shape[1]

    # device ME output (16px cell grid, 1/8-pel)
    if dm.mv0 is not None:
        dmv0 = np.ascontiguousarray(dm.mv0, dtype=np.int32)
        keep.append(dmv0)
        p.dev_mv0 = dmv0.ctypes.data
        p.dev_mv_h, p.dev_mv_w = dmv0.shape[0], dmv0.shape[1]
        if dm.mv1 is not None:
            dmv1 = np.ascontiguousarray(dm.mv1, dtype=np.int32)
            keep.append(dmv1)
            p.dev_mv1 = dmv1.ctypes.data
        if dm.mv2 is not None:
            dmv2 = np.ascontiguousarray(dm.mv2, dtype=np.int32)
            keep.append(dmv2)
            p.dev_mv2 = dmv2.ctypes.data

    # LRF pass-2 state
    if te.rs is not None:
        p.lrf_present = 1
        for pli in range(3):
            rp = te.rs.planes[pli]
            lp = LrfPlaneC()
            lp.lrf_type = rp.cfg.lrf_type
            lp.cols, lp.rows = rp.cfg.cols, rp.cfg.rows
            lp.sb_h_shift, lp.sb_v_shift = rp.cfg.sb_h_shift, rp.cfg.sb_v_shift
            lp.sb_cols, lp.sb_rows = rp.cfg.sb_cols, rp.cfg.sb_rows
            n = rp.cfg.cols * rp.cfg.rows
            kind = np.zeros(n, dtype=np.int32)
            sgr_set = np.zeros(n, dtype=np.int32)
            xqd = np.zeros(n * 2, dtype=np.int32)
            wiener = np.zeros(n * 6, dtype=np.int32)
            for uy in range(rp.cfg.rows):
                for ux in range(rp.cfg.cols):
                    u = uy * rp.cfg.cols + ux
                    f = rp.units[uy][ux]
                    if f[0] == "sgr":
                        kind[u] = 1
                        sgr_set[u] = f[1]
                        xqd[2 * u] = f[2][0]
                        xqd[2 * u + 1] = f[2][1]
                    elif f[0] == "wiener":
                        kind[u] = 2
                        for q in range(2):
                            for i in range(3):
                                wiener[6 * u + 3 * q + i] = f[1][q][i]
            keep.extend([kind, sgr_set, xqd, wiener])
            lp.kind = kind.ctypes.data
            lp.sgr_set = sgr_set.ctypes.data
            lp.xqd = xqd.ctypes.data
            lp.wiener = wiener.ctypes.data
            p.lrf[pli] = lp

    stats = np.zeros(80, dtype=np.uint32)
    keep.append(stats)
    p.stats = stats.ctypes.data

    # pass-1/2 coefficient log: record on pass 1, replay (symbol-only,
    # no pixel work) on pass 2
    clog_buf = None
    clog_len = None
    clog_in = getattr(te, "coeff_log_in", None)
    if getattr(te, "reuse_blocks", None) is not None and clog_in is not None:
        buf, used = clog_in
        p.coeff_log_mode = 2
        p.coeff_log = buf.ctypes.data
        p.coeff_log_cap = buf.nbytes
        clog_len = ctypes.c_long(used)
        p.coeff_log_len = ctypes.addressof(clog_len)
        keep.extend([buf, clog_len])
    elif getattr(te, "decision_log", None) is not None:
        px = (te.mi_w * 4) * (te.mi_h * 4)
        clog_buf = np.empty(px * 10 + (1 << 17), dtype=np.uint8)
        p.coeff_log_mode = 1
        p.coeff_log = clog_buf.ctypes.data
        p.coeff_log_cap = clog_buf.nbytes
        clog_len = ctypes.c_long(0)
        p.coeff_log_len = ctypes.addressof(clog_len)
        keep.extend([clog_buf, clog_len])

    # pass-2 decision reuse from pass 1's frame-level grids
    rb = getattr(te, "reuse_blocks", None)
    if rb is not None:
        p.reuse = 1
        ii = rb.is_inter_flag.view(np.uint8)
        rf = rb.ref_frames
        mv = rb.mv
        keep.extend([ii, rf, mv, rb])
        p.reuse_is_inter = ii.ctypes.data
        p.reuse_is_inter_s = ii.strides[0] // ii.itemsize
        p.reuse_ref = rf.ctypes.data
        p.reuse_ref_s = rf.strides[0] // (rf.itemsize * 2)
        p.reuse_mv = mv.ctypes.data
        p.reuse_mv_s = mv.strides[0] // (mv.itemsize * 4)

    # CDFs + grids
    ptrs, strides, last = _cdf_arrays(te.fc, keep)
    tr, bl = _avail_tables()

    blocks = te.blocks
    grid_names = [
        "mode", "uv_mode", "bsize", "skip", "tx_size", "segmentation_idx",
        "is_inter_flag", "ref_frames", "mv",
    ]
    gptrs = np.zeros(9, dtype=np.int64)
    gstrides = np.zeros(9, dtype=np.int64)
    for i, name in enumerate(grid_names):
        arr = getattr(blocks, name)
        gptrs[i] = arr.ctypes.data
        gstrides[i] = arr.strides[0] // arr.itemsize
        keep.append(arr)
    keep.extend([gptrs, gstrides, tr, bl])

    cap = max(te.mi_w * te.mi_h * 64 * 4, 1 << 16)
    out = np.zeros(cap, dtype=np.uint8)
    keep.append(out)
    n = lib.tile_encode(
        ctypes.byref(p), ptrs.ctypes.data, strides.ctypes.data,
        last.ctypes.data, tr.ctypes.data, bl.ctypes.data,
        gptrs.ctypes.data, gstrides.ctypes.data, out.ctypes.data, cap,
    )
    if n < 0:
        return None
    if clog_buf is not None:
        te.coeff_log_out = (clog_buf, int(clog_len.value))

    st = EncoderStats()
    for bs in range(22):
        if stats[bs]:
            st.block_size_counts[bs] = int(stats[bs])
    st.skip_block_count = int(stats[22])
    for m in range(41):
        if stats[23 + m]:
            st.luma_pred_mode_counts[m] = int(stats[23 + m])
    for m in range(15):
        if stats[64 + m]:
            st.chroma_pred_mode_counts[m] = int(stats[64 + m])
    return bytes(out[:n].tobytes()), st
