"""Batched device frame analysis: the search half of the encoder.

Counterpart of ``rav1e_tpu/device/analysis.py``.  One call per frame:

- all 13 intra prediction modes for every block at every partition size as
  one (n_blocks, 13, s, s) batch per size, scored by SATD through the
  :func:`kernels.satd8` kernel;
- a transform-domain rate/distortion estimate of the winning mode's
  residual (forward DCT, quantise, per-level rate, quantisation error);
- inter costing of the motion-compensated residual from the device ME field
  (:mod:`rav1e_tpu_torch.device.me`);
- the bottom-up partition merge D + lambda R over sizes 8..64.

PyTorch launches are asynchronous on a CUDA device: :func:`analyze_frame_async`
returns tensors that may still be in flight, and :func:`analyze_finish` copies
them to the host.  A pipeline's analyses run through its
``device/graphs.AnalysisPrograms``: on a card one CUDA graph per (padded
shape, bit depth, references) replays :func:`analysis_call` after the key's
first frame, the counterpart of the reference's ``frame_analysis_jit``.

When more than one card is visible, the frame's rows shard over all of them
(:func:`_analysis_mesh`): each band of whole superblock rows is analysed on
its card with a halo of the real rows around it, wide enough that its
interior decisions are the whole-frame run's, so the packets do not change.
Each band runs through the pipeline's runner for its slot
(``device/graphs.BandPrograms``, one CUDA graph per key on its card), the
counterpart of the reference's GSPMD-partitioned ``frame_analysis_jit``;
:func:`_mesh_frame_analysis` is the same banding run eagerly.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import numpy as np
import torch

from rav1e_tpu_torch import tables
from rav1e_tpu_torch.partition import PredictionMode, intra_mode_to_angle
from rav1e_tpu_torch.device import kernels
from rav1e_tpu_torch.device.constants import (
    EDGE_KERNELS,
    HDR_BITS,
    INTER_BITS,
    SIZE_LOG2S,
    SPLIT_BITS,
    device_cache,
    dir_plan,
    filter_idx,
    ief_static,
)
from rav1e_tpu_torch.device.constants import on as _tables
from rav1e_tpu_torch.device.me import me_field
from rav1e_tpu_torch.parallel.mesh import (
    ANALYSIS_HALO,
    ShardedPlane,
    band_rows,
    make_mesh,
    on_slot,
    send_back,
)

_I32 = torch.int32
_F32 = torch.float32

_DIR_MODES = (
    PredictionMode.D45_PRED,
    PredictionMode.D135_PRED,
    PredictionMode.D113_PRED,
    PredictionMode.D157_PRED,
    PredictionMode.D203_PRED,
    PredictionMode.D67_PRED,
)


# ---------------------------------------------------------------------------
# intra prediction of every mode (the normative intra-edge pipeline)
# ---------------------------------------------------------------------------


@device_cache
def _filter_idx_t(L: int, num: int, device):
    mats, valid = filter_idx(L, num)
    return (tuple(torch.as_tensor(m, device=device) for m in mats),
            torch.as_tensor(valid, device=device))


def _filter_edge_dev(buf, num: int, strength: int):
    """Batched spec 7.11.2.12 edge filter over (n, L) buffers: positions
    1..num-1 filtered with taps clamped to [0, num-1], rest untouched."""
    if strength == 0:
        return buf
    mats, valid = _filter_idx_t(buf.shape[1], num, buf.device)
    k = EDGE_KERNELS[strength - 1]
    acc = None
    for j in range(5):
        if k[j] == 0:
            continue
        t = k[j] * buf[:, mats[j]]
        acc = t if acc is None else acc + t
    out = (acc + 8) >> 4
    return torch.where(valid[None, :], out, buf)


def _upsample_edge_dev(buf, num_px: int, bd: int):
    """Batched spec 7.11.2.11 edge upsample: (n, >=num_px+1) buffer with
    index 0 = top-left -> (n, 2*num_px+1), incl. the C-style truncating /16."""
    dup = torch.cat(
        [buf[:, :1], buf[:, : num_px + 1], buf[:, num_px : num_px + 1]], dim=1
    )
    t = (
        -dup[:, 0:num_px] + 9 * dup[:, 1 : num_px + 1]
        + 9 * dup[:, 2 : num_px + 2] - dup[:, 3 : num_px + 3]
    )
    q = t + 8
    # truncating division: |q| // 16 before the sign (torch's // floors)
    q = torch.sign(q) * (q.abs() // 16)
    odd = q.clamp(0, (1 << bd) - 1)
    even = dup[:, 2 : num_px + 2]
    inter = torch.stack([odd, even], dim=2).reshape(buf.shape[0], 2 * num_px)
    return torch.cat([dup[:, 0:1], inter], dim=1)


@device_cache
def _dir_plan_t(s, p_angle, ua, ul, La, Ll, device):
    """dir_plan with its index / shift / mask arrays as tensors on device."""

    def t(a):
        return torch.as_tensor(a, device=device)

    plan = dir_plan(s, p_angle, ua, ul, La, Ll)
    if plan[0] == "above":
        _, i0, i1, sh, in_range, last_i = plan
        return ("above", (t(i0), t(i1), t(sh)), t(in_range), last_i)
    if plan[0] == "left":
        _, i0, i1, sh, _, _ = plan
        return ("left", (t(i0), t(i1), t(sh)), None, None)
    _, pa, pl_, use_above, _ = plan
    return ("mix", (tuple(map(t, pa)), tuple(map(t, pl_))), t(use_above), None)


def _take_blend(buf, i0, i1, shift):
    """buf: (n, L); index/blend matrices (s, s) -> (n, s, s)."""
    a = buf[:, i0]
    b = buf[:, i1]
    return (a * (32 - shift) + b * shift + 16) >> 5


def _dir_pred_exact(above_buf, left_buf, tl, mode, s: int, bd: int):
    """One directional mode's prediction with the normative edge pipeline:
    top-left corner filter -> edge filter -> edge upsample -> gather/blend
    (spec 7.11.2.7-.12), batched over n blocks."""
    p_angle = intra_mode_to_angle(mode)
    st_a, st_l, ups_a, ups_l, num_a, num_l = ief_static(s, p_angle)
    abuf, lbuf = above_buf, left_buf
    if 90 < p_angle < 180 and 2 * s >= 24:
        # corner smoothing (ops/intra_edges.build_intra_edge:142-150)
        tlf = (lbuf[:, s] * 5 + tl * 6 + abuf[:, 1] * 5 + 8) >> 4
        abuf = torch.cat([tlf[:, None], abuf[:, 1:]], dim=1)
        lbuf = torch.cat([tlf[:, None], lbuf[:, 1:]], dim=1)
    abuf = _filter_edge_dev(abuf, num_a + 1, st_a)
    lbuf = _filter_edge_dev(lbuf, num_l + 1, st_l)
    ua = ul = 0
    if ups_a:
        abuf = _upsample_edge_dev(abuf, num_a, bd)
        ua = 1
    if ups_l:
        lbuf = _upsample_edge_dev(lbuf, num_l, bd)
        ul = 1
    kind, idx, mask, last_i = _dir_plan_t(
        s, p_angle, ua, ul, abuf.shape[1], lbuf.shape[1], abuf.device
    )
    if kind == "above":
        v = _take_blend(abuf, *idx)
        v = torch.where(mask, v, abuf[:, last_i][:, None, None])
    elif kind == "left":
        v = _take_blend(lbuf, *idx)
    else:
        v = torch.where(mask, _take_blend(abuf, *idx[0]),
                        _take_blend(lbuf, *idx[1]))
    return v.clamp(0, (1 << bd) - 1)


def predict_all_modes(above2, left2, tl, s: int, bd: int):
    """All 13 intra predictions per block: (n, 13, s, s) int32.

    above2/left2: (n, 2s) int32 source edges; tl: (n,) int32.
    """
    n = above2.shape[0]
    a = above2[:, :s]
    l = left2[:, :s]

    dc = (a.sum(-1) + l.sum(-1) + s) // (2 * s)
    dc = dc.to(_I32)[:, None, None].expand(n, s, s)
    v = a[:, None, :].expand(n, s, s)
    h = l[:, :, None].expand(n, s, s)

    # Paeth (spec 7.11.2.2)
    lc, ar, tlc = l[:, :, None], a[:, None, :], tl[:, None, None]
    base_p = lc + ar - tlc
    pl = (base_p - lc).abs()
    pt = (base_p - ar).abs()
    ptl = (base_p - tlc).abs()
    paeth = torch.where(
        (pl <= pt) & (pl <= ptl),
        lc.expand_as(base_p),
        torch.where(pt <= ptl, ar.expand_as(base_p), tlc.expand_as(base_p)),
    )

    # Smooth family (spec 7.11.2.6)
    w = _tables(above2.device).sm_weights[s]
    wv = w[None, :, None]
    ww = w[None, None, :]
    below = l[:, -1][:, None, None]
    right = a[:, -1][:, None, None]
    smooth = (
        wv * ar + (256 - wv) * below + ww * lc + (256 - ww) * right + 256
    ) >> 9
    smooth_v = (wv * ar + (256 - wv) * below + 128) >> 8
    smooth_h = (ww * lc + (256 - ww) * right + 128) >> 8

    # directional at angle_delta = 0 through the normative edge pipeline
    above_buf = torch.cat([tl[:, None], above2], dim=1)
    left_buf = torch.cat([tl[:, None], left2], dim=1)
    dirs = {
        int(m): _dir_pred_exact(above_buf, left_buf, tl, m, s, bd)
        for m in _DIR_MODES
    }

    # order must match PredictionMode 0..12
    planes = [dc, v, h, dirs[3], dirs[4], dirs[5], dirs[6], dirs[7], dirs[8],
              smooth, smooth_v, smooth_h, paeth]
    return torch.stack([p.to(_I32).expand(n, s, s) for p in planes], dim=1)


# ---------------------------------------------------------------------------
# SATD and transform-domain rate/distortion estimation
# ---------------------------------------------------------------------------


def satd8(diff):
    """SATD over (..., s, s) int32 diffs using 8x8 Hadamard cells (ops/dist
    get_satd normalisation), through the satd8 kernel."""
    return kernels.satd8(diff)


@device_cache
def _ln2(device):
    """log(2) as a float32 0-d tensor on ``device``, made once: a graph
    capture of the analysis cannot make it from a host value."""
    return torch.log(torch.tensor(2.0, dtype=_F32, device=device))


def tx_rd_estimate(residual, s: int, q):
    """Transform-domain rate + distortion estimate of (n, s, s) residuals.

    q: 0-dim f32 ac quantizer (Q3 table units, tables.ac_q).  Returns
    (bits_est (n,), sse_px_est (n,)) float32.  The float32 DCT projection
    sums in another order than the reference's, so results agree to float32
    rounding, not bit for bit.
    """
    fv, fh, gain2, lts = _tables(residual.device).dct[s]
    c = torch.matmul(torch.matmul(fv, residual.to(_F32)), fh.T)
    if s > 32:
        # only the low 32x32 region is codable (transforms.py _zero_high)
        mask = (torch.arange(s, device=c.device) < 32).to(_F32)
        c = c * mask[None, :, None] * mask[None, None, :]
    qeff = q.to(_F32) / (1 << lts)
    ac = c.abs()
    level = torch.floor(ac / qeff + 0.45)
    err = ac - level * qeff
    sse_px = (err * err).sum(dim=(1, 2)) / gain2
    # per-coefficient rate: ~golomb-ish growth, small floor for coded zeros
    # (log2 as log(x) / log(2), the jnp.log2 formulation)
    bits = torch.where(level > 0,
                       1.8 + 1.9 * (torch.log(level + 1.0) / _ln2(c.device)),
                       0.02)
    return bits.sum(dim=(1, 2)), sse_px


# ---------------------------------------------------------------------------
# per-size cost fields
# ---------------------------------------------------------------------------


def _block_edges(luma, s: int, base: int):
    """Split padded (H, W) luma into s-blocks with source edges.

    Returns blocks (n, s, s), above2 (n, 2s), left2 (n, 2s), tl (n,);
    row/col -1 use the spec base values, extensions clamp at the frame edge.
    """
    hh, ww = luma.shape
    ny, nx = hh // s, ww // s
    dev = luma.device
    blocks = luma.reshape(ny, s, nx, s).permute(0, 2, 1, 3).reshape(-1, s, s)

    with_top = torch.cat(
        [torch.full((1, ww), base - 1, dtype=luma.dtype, device=dev), luma],
        dim=0,
    )
    ys = (torch.arange(ny, device=dev) * s)[:, None, None]
    xs = ((torch.arange(nx, device=dev) * s)[None, :, None]
          + torch.arange(2 * s, device=dev)[None, None, :])
    above2 = with_top[ys, xs.clamp(max=ww - 1)]  # (ny, nx, 2s)

    with_left = torch.cat(
        [torch.full((hh, 1), base + 1, dtype=luma.dtype, device=dev), luma],
        dim=1,
    )
    xs_l = (torch.arange(nx, device=dev) * s)[None, :, None]
    ys_l = ((torch.arange(ny, device=dev) * s)[:, None, None]
            + torch.arange(2 * s, device=dev)[None, None, :])
    left2 = with_left[ys_l.clamp(max=hh - 1), xs_l]  # (ny, nx, 2s)

    corner = torch.nn.functional.pad(
        luma[s - 1 :: s, s - 1 :: s], (1, 0, 1, 0), value=base
    )[:ny, :nx]

    return (
        blocks,
        above2.reshape(-1, 2 * s),
        left2.reshape(-1, 2 * s),
        corner.reshape(-1),
        ny,
        nx,
    )


def intra_cost_field(luma, s: int, bd: int, q, lam, gaps=None):
    """Per-block intra cost at size s: (ny*nx,) cost, best mode, rate.

    ``gaps``, when a dict, receives the relative score gap between the best
    and second-best mode of each block under the key ("mode", s)."""
    base = 128 << (bd - 8)
    blocks, above2, left2, tl, ny, nx = _block_edges(luma, s, base)
    preds = predict_all_modes(above2, left2, tl, s, bd)
    diffs = blocks[:, None].to(_I32) - preds
    satd = satd8(diffs)  # (n, 13)
    mode_rate = _tables(luma.device).mode_bits
    # SATD (~ sqrt-domain) pick with a rate tiebreak scaled to SATD units
    score = satd + torch.sqrt(lam) * mode_rate[None, :]
    best_mode = torch.argmin(score, dim=1).to(_I32)
    if gaps is not None:
        two = torch.topk(score, 2, dim=1, largest=False).values
        gaps[("mode", s)] = _rel_gap(two[:, 0], two[:, 1])
    best_diff = diffs[torch.arange(diffs.shape[0], device=luma.device),
                      best_mode.long()]
    bits, sse = tx_rd_estimate(best_diff, s, q)
    rate = bits + HDR_BITS + mode_rate[best_mode.long()]
    cost = sse + lam * rate
    return cost, best_mode, rate


def inter_cost_field(residual, s: int, q, lam):
    """Per-block inter cost at size s from the frame MC residual."""
    hh, ww = residual.shape
    ny, nx = hh // s, ww // s
    blocks = residual.reshape(ny, s, nx, s).permute(0, 2, 1, 3).reshape(-1, s, s)
    bits, sse = tx_rd_estimate(blocks, s, q)
    rate = bits + HDR_BITS + INTER_BITS
    cost = sse + lam * rate
    return cost, rate


def mc_residual(luma, ref, mv8):
    """Whole-frame fullpel MC residual from a per-8x8-cell MV field.

    luma/ref: (H, W) int32 padded planes (same geometry); mv8: (H/8, W/8, 2)
    int32 full-pixel (dy, dx).  Out-of-frame reads clamp.
    """
    hh, ww = luma.shape
    dev = luma.device
    ii = torch.arange(hh, device=dev)[:, None]
    jj = torch.arange(ww, device=dev)[None, :]
    dy = _up(mv8[..., 0], 3)[:hh, :ww]
    dx = _up(mv8[..., 1], 3)[:hh, :ww]
    sy = (ii + dy).clamp(0, hh - 1)
    sx = (jj + dx).clamp(0, ww - 1)
    return luma.to(_I32) - ref[sy, sx]


def _rel_gap(a, b):
    """|a - b| / max(|a|, |b|), 0 where both are 0."""
    den = torch.maximum(a.abs(), b.abs())
    return torch.where(den > 0, (a - b).abs() / den.clamp(min=1e-30),
                       torch.zeros_like(den))


# ---------------------------------------------------------------------------
# bottom-up partition merge + frame entry
# ---------------------------------------------------------------------------


@dataclass
class DeviceMaps:
    """Host-side view of the device decisions (numpy); the fields the host
    tile coders read, as ``rav1e_tpu.device.DeviceMaps`` has them."""

    size_log2: np.ndarray  # (H/8, W/8) chosen square size log2 per 8px cell
    mode: np.ndarray  # (H/8, W/8) intra PredictionMode at the chosen size
    use_inter: np.ndarray  # (H/8, W/8) bool: inter beat intra at chosen size
    bits_est: float  # frame rate-estimate total (RC aggregation input)
    mv0: np.ndarray = None  # (H/16, W/16, 2) int32 1/8-pel MVs vs fwd ref
    mv1: np.ndarray = None  # same vs bwd ref (when the pyramid provides one)
    mv2: np.ndarray = None  # same vs the far backward anchor (BWDREF)


def _up(a, k):
    """Repeat each cell of the two leading dims 2**k times along both (as
    ``expand`` + ``reshape``: ``repeat_interleave`` may size its output on
    the host, which a graph capture cannot do)."""
    f = 1 << k
    ny, nx, *rest = a.shape
    return a[:, None, :, None].expand(ny, f, nx, f, *rest).reshape(
        ny * f, nx * f, *rest)


def _sum4(a):
    return a[0::2, 0::2] + a[0::2, 1::2] + a[1::2, 0::2] + a[1::2, 1::2]


def _merge_partitions(costs, modes, inters, rates, lam, gaps=None):
    """Bottom-up quadtree merge over SIZE_LOG2S (rdo.rs:1949 semantics as
    tensor select).  All decision maps live on the 8px cell grid.

    Returns (size_log2, mode, use_inter, rate_per_cell) maps at 8px cells.
    ``gaps``, when a dict, receives each merge's relative cost gap under
    ("merge", s)."""
    base_sl = SIZE_LOG2S[0]
    best_cost = costs[base_sl]  # block grid at the current (finest) level
    size_map = torch.full(best_cost.shape, base_sl, dtype=_I32,
                          device=best_cost.device)
    mode_map = modes[base_sl]
    inter_map = inters[base_sl]
    rate_map = rates[base_sl] / 1.0  # per-cell rate share
    for sl in SIZE_LOG2S[1:]:
        k = sl - base_sl
        ncells = float(1 << (2 * k))  # 8px cells covered by one sl-block
        merged = _sum4(best_cost) + lam * SPLIT_BITS
        keep_whole = costs[sl] <= merged
        if gaps is not None:
            gaps[("merge", 1 << sl)] = _rel_gap(costs[sl], merged)
        best_cost = torch.where(keep_whole, costs[sl], merged)
        kw_cells = _up(keep_whole, k)
        size_map = torch.where(kw_cells, sl, size_map)
        mode_map = torch.where(kw_cells, _up(modes[sl], k), mode_map)
        inter_map = torch.where(kw_cells, _up(inters[sl], k), inter_map)
        rate_map = torch.where(kw_cells, _up(rates[sl], k) / ncells, rate_map)
    return size_map, mode_map, inter_map, rate_map


def _frame_analysis(luma, ref0, ref1, ref2, q, lam, bd: int, has_inter: bool,
                    has_bwd: bool = False, has_bwd2: bool = False, gaps=None):
    """Whole-frame analysis: device ME vs each reference, then intra/inter
    cost fields and the partition merge.

    Returns (size_map, mode_map, inter_map, bits_est, mv0, mv1, mv2,
    rate_map); the MV maps are (H/16, W/16, 2) int32 in 1/8-pel units (zeros
    when unused).  ``gaps``, when a dict, receives the relative gap of every
    decision (mode pick, inter vs intra, merge) on the 8px cell grid, the
    smallest over sizes, under the key "min"."""
    dev = luma.device
    ny16, nx16 = luma.shape[0] // 16, luma.shape[1] // 16
    zeros = torch.zeros((ny16, nx16, 2), dtype=_I32, device=dev)
    mv8 = None
    if has_inter:
        mv0 = me_field(luma, ref0, bd)
        # full-pel part on the 8px cell grid drives the residual cost model
        mv8 = _up(mv0 >> 3, 1)
    else:
        mv0 = zeros
    mv1 = me_field(luma, ref1, bd) if (has_inter and has_bwd) else zeros
    mv2 = me_field(luma, ref2, bd) if (has_inter and has_bwd2) else zeros

    costs, modes, inters, rates = {}, {}, {}, {}
    res = mc_residual(luma, ref0, mv8) if has_inter else None
    for sl in SIZE_LOG2S:
        s = 1 << sl
        ny, nx = luma.shape[0] // s, luma.shape[1] // s
        ic, im, ir = intra_cost_field(luma, s, bd, q, lam, gaps)
        ic = ic.reshape(ny, nx)
        im = im.reshape(ny, nx)
        ir = ir.reshape(ny, nx)
        if has_inter:
            xc, xr = inter_cost_field(res, s, q, lam)
            xc = xc.reshape(ny, nx)
            use_x = xc < ic
            if gaps is not None:
                gaps[("inter", s)] = _rel_gap(xc, ic)
            costs[sl] = torch.where(use_x, xc, ic)
            rates[sl] = torch.where(use_x, xr.reshape(ny, nx), ir)
            inters[sl] = use_x
        else:
            costs[sl] = ic
            rates[sl] = ir
            inters[sl] = torch.zeros((ny, nx), dtype=torch.bool, device=dev)
        modes[sl] = im

    size_map, mode_map, inter_map, rate_map = _merge_partitions(
        costs, modes, inters, rates, lam, gaps
    )
    bits_est = rate_map.sum()
    if gaps is not None:
        gmin = torch.full(size_map.shape, float("inf"), device=dev)
        for (_, s), g in list(gaps.items()):
            g = g.reshape(luma.shape[0] // s, luma.shape[1] // s)
            gmin = torch.minimum(gmin, _up(g, s.bit_length() - 4))
        gaps["min"] = gmin
    return size_map, mode_map, inter_map, bits_est, mv0, mv1, mv2, rate_map


@functools.lru_cache(None)
def _analysis_mesh(device):
    """The production mesh of a context on ``device``: every visible card on
    a 1-D ``tile`` axis when the context is on a card and more than one is
    visible, else None.  ``RAV1E_TPU_NO_SHARD=1`` opts out.  Multi-card is
    automatic, as in the reference: each frame's analysis then runs by row
    bands over the cards, and the decisions, and therefore the packets, are
    the single-card run's."""
    if (os.environ.get("RAV1E_TPU_NO_SHARD")
            or torch.device(device).type != "cuda"
            or torch.cuda.device_count() <= 1):
        return None
    return make_mesh()


def _pad64(luma_np):
    h, w = luma_np.shape
    h64 = (h + 63) & ~63
    w64 = (w + 63) & ~63
    arr = np.pad(luma_np, ((0, h64 - h), (0, w64 - w)), mode="edge")
    if arr.dtype != np.uint8:
        arr = arr.astype(np.int32)  # 10/12-bit planes: widen on the host
    return np.ascontiguousarray(arr)


def upload_source_luma(luma_np: np.ndarray, device):
    """Pad a visible source-luma plane to 64-multiples and put it on
    ``device`` once.

    The result is usable as any plane input of :func:`analyze_frame_async`,
    so a frame that is its own analysis subject and later the reference of
    up to 3 future frames crosses to the device once.  Under the analysis
    mesh it is a :class:`ShardedPlane`, each band on its own device (on the
    mesh's first device when the frame does not split)."""
    arr = _pad64(luma_np)
    mesh = _analysis_mesh(device)
    if mesh is None:
        return torch.from_numpy(arr).to(device)
    rows = band_rows(arr.shape[0], mesh.size)
    if rows is None:
        return torch.from_numpy(arr).to(mesh.devices[0])
    return ShardedPlane.put(mesh, rows, arr)


def analyze_frame_async(luma_np, ref0_np, ref1_np, qindex: int, lam: float,
                        bd: int, ref2_np=None, *, device, programs=None):
    """Host entry: pad to 64-multiples, put the planes on ``device`` and
    launch the analysis.

    luma_np / ref0_np / ref1_np / ref2_np: (H, W) visible-luma numpy arrays
    (refs are the source planes of the forward / near-backward /
    far-backward references), or planes already on the device from
    :func:`upload_source_luma`.  Under the analysis mesh the planes shard
    by rows and each band runs on its slot (:func:`mesh_analysis`).  The
    frame, or each band, runs through ``programs``, the caller's
    ``device/graphs.AnalysisPrograms`` (on a card one CUDA graph per key
    after the key's first frame; a band through the runner the set holds
    for its slot); without one, through a runner of its own, whose only
    frame runs eagerly.  Returns a handle for :func:`analyze_finish`.
    """
    device = torch.device(device)
    mesh = _analysis_mesh(device)
    rows = None
    if mesh is not None:
        # a frame that does not split is analysed whole on the first slot
        device = mesh.devices[0]
        rows = band_rows(_padded_shape(luma_np)[0], mesh.size)

    def prep(p):
        if isinstance(p, ShardedPlane):
            if rows is None or p.rows != rows or p.mesh is not mesh:
                raise ValueError("plane sharded over another mesh than the "
                                 "analysis's")
            return p
        if isinstance(p, torch.Tensor):
            if rows is not None:
                raise ValueError(f"plane on {p.device}, analysis sharded "
                                 "over a mesh")
            if p.device.type != device.type:
                raise ValueError(f"plane on {p.device}, analysis on {device}")
            return p
        if rows is not None:
            return ShardedPlane.put(mesh, rows, _pad64(p))
        return torch.from_numpy(_pad64(p)).to(device)

    luma = prep(luma_np)
    has_inter = ref0_np is not None
    has_bwd = has_inter and ref1_np is not None
    has_bwd2 = has_bwd and ref2_np is not None
    ref0 = prep(ref0_np) if has_inter else luma
    ref1 = prep(ref1_np) if has_bwd else ref0
    ref2 = prep(ref2_np) if has_bwd2 else ref0
    for r in (ref0, ref1, ref2):
        if tuple(r.shape) != tuple(luma.shape):
            raise ValueError(f"plane shapes {tuple(r.shape)} and "
                             f"{tuple(luma.shape)} differ")
    flags = (has_inter, has_bwd, has_bwd2)
    if programs is None:
        from rav1e_tpu_torch.device.graphs import AnalysisPrograms

        programs = AnalysisPrograms(device)
    q = float(tables.ac_q(qindex, 0, bd))
    if rows is not None:
        out = mesh_analysis(mesh, rows, (luma, ref0, ref1, ref2), q, lam, bd,
                            flags, programs)
    else:
        out = programs.run(luma, ref0, ref1, ref2, q, lam, bd, flags)
    return out, *flags


def analysis_call(d, bd: int, flags):
    """The analysis of one frame on the static buffers of an
    ``AnalysisPrograms`` key: ``d`` holds the padded planes "luma" and, as
    ``flags`` (has_inter, has_bwd, has_bwd2) ask, "ref0", "ref1", "ref2"
    (any integer type), and "qlam", the (2,) float32 ac quantizer and
    lambda.  Returns its seven outputs packed (:func:`pack_outputs`)."""
    out = _frame_analysis(*_key_planes(d, flags), d["qlam"][0], d["qlam"][1],
                          bd, *flags)
    return pack_outputs(out[:7])


def _key_planes(d, flags):
    """(luma, ref0, ref1, ref2) as int32 from a key's static buffers: the
    references ``flags`` leave out stand in as the whole-frame run has
    them."""
    luma = d["luma"].to(_I32)
    ref0 = d["ref0"].to(_I32) if flags[0] else luma
    ref1 = d["ref1"].to(_I32) if flags[1] else ref0
    ref2 = d["ref2"].to(_I32) if flags[2] else ref0
    return luma, ref0, ref1, ref2


def band_call(d, top: int, rows: int, bd: int, flags):
    """The analysis of one band of the mesh on the static buffers of a
    ``BandPrograms`` key: ``d`` holds the band's window of each plane the
    key reads (its ``rows`` interior rows after ``top`` halo rows) and
    "qlam", as :func:`analysis_call`.  Returns the interior's size, mode and
    inter maps, rate map and mv0-mv2 packed (``pack_outputs(..., band=
    True)``): what :func:`_mesh_frame_analysis` keeps of a band."""
    size_map, mode_map, inter_map, _bits, mv0, mv1, mv2, rate_map = \
        _frame_analysis(*_key_planes(d, flags), d["qlam"][0], d["qlam"][1],
                        bd, *flags)
    c, nc = top // 8, rows // 8
    m, nm = top // 16, rows // 16
    return pack_outputs(
        [t[c : c + nc] for t in (size_map, mode_map, inter_map, rate_map)]
        + [t[m : m + nm] for t in (mv0, mv1, mv2)], band=True)


def _out_spec(shape, band=False):
    """(dtype, shape) of each of an analysis's seven outputs in handle
    order, for a padded plane of ``shape``; with ``band``, of the outputs
    a band of the mesh keeps for its ``shape`` interior, the rate map in
    place of bits_est."""
    h, w = shape
    n8, n16 = (h // 8, w // 8), (h // 16, w // 16, 2)
    return ((_I32, n8), (_I32, n8), (torch.bool, n8),
            (_F32, n8 if band else ()), (_I32, n16), (_I32, n16), (_I32, n16))


# pack order: the bool inter map last, so every other section starts at a
# multiple of 4 bytes
_PACK_ORDER = (0, 1, 3, 4, 5, 6, 2)


def pack_outputs(outs, band=False):
    """An analysis's seven outputs (size, mode and inter maps, bits_est, or
    with ``band`` a band's rate map, mv0-mv2) as one uint8 tensor, so that a
    replay's results are copied out of the graph's memory in one clone
    (:func:`unpack_outputs` undoes it)."""
    spec = _out_spec((outs[0].shape[0] * 8, outs[0].shape[1] * 8), band)
    for t, (dtype, shape) in zip(outs, spec):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"analysis output {t.dtype} {tuple(t.shape)}, "
                             f"expected {dtype} {shape}")
    return torch.cat([outs[i].reshape(-1).view(torch.uint8)
                      for i in _PACK_ORDER])


def unpack_outputs(flat, shape, band=False):
    """The seven outputs of a :func:`pack_outputs` buffer for a padded plane
    of ``shape`` (with ``band``, a band's interior), as views into it."""
    spec = _out_spec(shape, band)
    views, o = [None] * 7, 0
    for i in _PACK_ORDER:
        dtype, shp = spec[i]
        n = int(np.prod(shp, dtype=np.int64)) * dtype.itemsize
        views[i] = flat[o : o + n].view(dtype).reshape(shp)
        o += n
    return tuple(views)


def _padded_shape(p):
    if isinstance(p, (torch.Tensor, ShardedPlane)):
        return tuple(p.shape)
    h, w = p.shape
    return ((h + 63) & ~63, (w + 63) & ~63)


def _scalars(qindex: int, lam: float, bd: int, device):
    """q and lambda as float32 0-d tensors, for the eager analyses (a runner's
    key loads the same values into its static "qlam")."""
    q = float(tables.ac_q(qindex, 0, bd))
    return (torch.tensor(q, dtype=_F32, device=device),
            torch.tensor(lam, dtype=_F32, device=device))


def _mesh_frame_analysis(mesh, rows, planes, qindex, lam, bd, flags):
    """The frame analysis by row bands over the mesh's slots.

    Each band takes its superblock rows plus up to ``ANALYSIS_HALO`` real
    rows on each side (none past the frame's edge, so the pyramid's edge
    padding replicates the rows the whole-frame run replicates), runs
    :func:`_frame_analysis` on its slot and keeps its interior.  The maps,
    MV fields and rate maps gather onto the first slot; the rate map is
    summed there whole, in the order of the unsharded run, so ``bits_est``
    is the unsharded value too.  The plain version of :func:`mesh_analysis`,
    for the comparisons."""
    h = rows[-1][1]
    dev0 = mesh.devices[0]
    parts = []
    for i, (lo, hi) in enumerate(rows):
        top = min(ANALYSIS_HALO, lo)
        bot = min(ANALYSIS_HALO, h - hi)
        ext = {}
        for p in planes:
            if id(p) not in ext:
                ext[id(p)] = p.window(i, lo - top, hi + bot)
        with on_slot(mesh, i):
            bands = [ext[id(p)].to(_I32) for p in planes]
            q, lam_t = _scalars(qindex, lam, bd, mesh.devices[i])
            size_map, mode_map, inter_map, _b, mv0, mv1, mv2, rate_map = \
                _frame_analysis(*bands, q, lam_t, bd, *flags)
            c, nc = top // 8, (hi - lo) // 8
            m, nm = top // 16, (hi - lo) // 16
            interior = [t[c : c + nc] for t in (size_map, mode_map,
                                                inter_map, rate_map)]
            interior += [t[m : m + nm] for t in (mv0, mv1, mv2)]
        parts.append([send_back(t, mesh, i, dev0) for t in interior])
    size_map, mode_map, inter_map, rate_map, mv0, mv1, mv2 = (
        torch.cat([pt[k] for pt in parts]) for k in range(7))
    return size_map, mode_map, inter_map, rate_map.sum(), mv0, mv1, mv2


def mesh_analysis(mesh, rows, planes, q: float, lam: float, bd: int, flags,
                  programs):
    """:func:`_mesh_frame_analysis` with each band run by ``programs``'
    runner for its slot (``AnalysisPrograms.band``): the band's window of
    each plane the key reads and q/lambda go into the key's static buffers
    on the slot's stream, and the runner returns the interior's outputs
    packed, copied out of its memory on that stream.  The packed bands
    gather onto the first slot, where they are unpacked and the rate map is
    summed whole, as the eager version does.

    Every slot receives its windows before any band runs, and every band is
    enqueued before any is gathered: a gather orders the gathering stream
    behind the band's slot, and a window received after it would order the
    next slot behind that, so the bands would run one after another."""
    h, w = rows[-1][1], planes[0].shape[1]
    dev0 = mesh.devices[0]
    bands = []
    for i, (lo, hi) in enumerate(rows):
        top = min(ANALYSIS_HALO, lo)
        bot = min(ANALYSIS_HALO, h - hi)
        bands.append((top, hi - lo, [
            p.window(i, lo - top, hi + bot) if used else None
            for p, used in zip(planes, (True, *flags))]))
    flats = []
    for i, (top, n, windows) in enumerate(bands):
        with on_slot(mesh, i):
            flats.append(programs.band(mesh, i).run(*windows, top, n, q, lam,
                                                    bd, flags))
    parts = [unpack_outputs(send_back(flat, mesh, i, dev0), (n, w), band=True)
             for i, (flat, (_, n, _)) in enumerate(zip(flats, bands))]
    size_map, mode_map, inter_map, rate_map, mv0, mv1, mv2 = (
        torch.cat([pt[k] for pt in parts]) for k in range(7))
    return size_map, mode_map, inter_map, rate_map.sum(), mv0, mv1, mv2


def analyze_finish(handle) -> DeviceMaps:
    """Copy an :func:`analyze_frame_async` result to the host."""
    (size_map, mode_map, inter_map, bits_est, mv0, mv1, mv2), \
        has_inter, has_bwd, has_bwd2 = handle
    bits16 = torch.round(bits_est * 16.0).to(_I32)
    return DeviceMaps(
        size_log2=size_map.cpu().numpy(),
        mode=mode_map.cpu().numpy(),
        use_inter=inter_map.cpu().numpy(),
        bits_est=float(bits16.item()) / 16.0,
        mv0=mv0.cpu().numpy() if has_inter else None,
        mv1=mv1.cpu().numpy() if has_bwd else None,
        mv2=mv2.cpu().numpy() if has_bwd2 else None,
    )


def analyze_frame(luma_np, ref0_np, ref1_np, qindex: int, lam: float, bd: int,
                  ref2_np=None, *, device) -> DeviceMaps:
    """Synchronous host entry: launch + fetch in one call."""
    return analyze_finish(
        analyze_frame_async(luma_np, ref0_np, ref1_np, qindex, lam, bd,
                            ref2_np, device=device)
    )
