"""rav1e_tpu_torch.device.chain against rav1e_tpu.device.chain on the CPU:
the host builders (plan, geometry, aux layout, coefficient log, decision
grids, plane layouts) give equal numpy outputs; each of the five device
stages, fed the same seeded inputs, gives exactly the outputs of its JAX
stage at one 192x128 geometry with both backward references on.  The JAX
stages compile once per module.  The chain-on encodes against rav1e_tpu are
tests/test_torch_encode.py's (192x128, 4 frames, beside the chain-off
encode of the same geometry, whose reference analysis compiles it shares)
and tests/test_torch_chain_encode.py's (``slow``)."""

import dataclasses

import numpy as np
import pytest
import torch
from torch_threads import one_torch_cpu_thread  # noqa: F401

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from rav1e_tpu.device import chain as rchain  # noqa: E402
from rav1e_tpu_torch.device import chain  # noqa: E402
from rav1e_tpu_torch.device.graphs import ChainPrograms  # noqa: E402

W, H = 192, 128
MI_COLS, MI_ROWS = 2 * ((W + 7) >> 3), 2 * ((H + 7) >> 3)
PR_MIN, PR_MAX = 3, 6  # speed 6 partition range


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want, msg=""):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=msg)


def _size_map(rng, mi_cols, mi_rows):
    nby = ((mi_rows + 15) // 16) * 8
    nbx = ((mi_cols + 15) // 16) * 8
    return rng.integers(3, 7, (nby, nbx)).astype(np.int32)


def _geom_tuple(g):
    return dataclasses.astuple(g), (g.gw, g.gh, g.ntx_cap, g.lcap)


# ---------------------------------------------------------------------------
# host builders
# ---------------------------------------------------------------------------

GEOMS = [(128, 96, False), (128, 96, True), (136, 88, False), (136, 88, True),
         (200, 72, False)]


@pytest.mark.parametrize("w,h,tx_split", GEOMS)
def test_build_plan_and_geom(w, h, tx_split):
    rng = np.random.default_rng(w + h + tx_split)
    mi_cols, mi_rows = 2 * ((w + 7) >> 3), 2 * ((h + 7) >> 3)
    for pr_min, pr_max in ((3, 6), (4, 5), (2, 6)):
        sl = _size_map(rng, mi_cols, mi_rows)
        want = rchain.build_plan(sl, mi_cols, mi_rows, pr_min, pr_max, tx_split)
        got = chain.build_plan(sl, mi_cols, mi_rows, pr_min, pr_max, tx_split)
        assert (got.n_tx, got.n_blk) == (want.n_tx, want.n_blk)
        for f in ("magics", "blk_x8", "blk_y8", "blk_sl", "eff8"):
            _eq(getattr(got, f), getattr(want, f), f)
        assert sorted(got.ords) == sorted(want.ords)
        for k in got.ords:
            _eq(got.ords[k], want.ords[k], str(k))
        for bwd in (False, True):
            a = chain.geom_for(w, h, mi_cols, mi_rows, 8, tx_split, bwd, bwd,
                               pr_min, pr_max)
            b = rchain.geom_for(w, h, mi_cols, mi_rows, 8, tx_split, bwd,
                                bwd, pr_min, pr_max)
            assert _geom_tuple(a) == _geom_tuple(b)
            assert chain._aux_layout(a) == rchain._aux_layout(b)


def _frame_inputs(geom, plan, rng):
    """Seeded per-frame small inputs: MV fields (a zero block forces SAD
    ties between candidates 0 and 3), per-8px quantizers varying like a
    segmentation map, deblock levels, CDEF candidate lists."""
    from rav1e_tpu import tables
    from rav1e_tpu.ops.cdef import CDEF_SEC_STRENGTHS, cdef_strengths_fast

    ny16, nx16 = geom.gh // 16, geom.gw // 16
    fields = rng.integers(-96, 97, (3, ny16, nx16, 2)).astype(np.int32)
    fields[:, : ny16 // 2, : nx16 // 2] = 0
    # below: bands where only field 1, or only field 2, points at its
    # reference's true shift (stage_case shifts reference k right by k + 1
    # luma px), so ALTREF and BWDREF win there
    fields[1, ny16 // 2 : 3 * ny16 // 4] = (0, 16)
    fields[2, 3 * ny16 // 4 :] = (0, 24)
    fields[1, 0, 0] = (rchain.MV_CLIP, -rchain.MV_CLIP)
    nby8, nbx8 = geom.gh // 8, geom.gw // 8
    qi = np.array([90, 150, 210])[rng.integers(0, 3, (nby8, nbx8))]
    dcq8 = np.stack([np.vectorize(lambda q: tables.dc_q(int(q), d, 8))(qi)
                     for d in (0, -2, 3)]).astype(np.int32)
    acq8 = np.stack([np.vectorize(lambda q: tables.ac_q(int(q), d, 8))(qi)
                     for d in (0, -2, 3)]).astype(np.int32)
    cdef_y, cdef_uv = cdef_strengths_fast(tables.ac_q(90, 0, 8))
    pri, sec = divmod(cdef_y, CDEF_SEC_STRENGTHS)
    y_list = [0, cdef_y, max(pri // 2, 1) * CDEF_SEC_STRENGTHS + sec,
              min(pri * 2 + 1, 15) * CDEF_SEC_STRENGTHS + sec]
    pri_uv, sec_uv = divmod(cdef_uv, CDEF_SEC_STRENGTHS)
    uv_list = [0, cdef_uv, max(pri_uv // 2, 0) * CDEF_SEC_STRENGTHS + sec_uv,
               min(pri_uv * 2 + 1, 15) * CDEF_SEC_STRENGTHS + sec_uv]
    return fields, dcq8, acq8, [24, 20, 12, 10], y_list, uv_list


def test_pack_aux_coeff_log_and_decisions():
    rng = np.random.default_rng(5)
    sl = _size_map(rng, MI_COLS, MI_ROWS)
    for tx_split in (False, True):
        plan = chain.build_plan(sl, MI_COLS, MI_ROWS, PR_MIN, PR_MAX, tx_split)
        rplan = rchain.build_plan(sl, MI_COLS, MI_ROWS, PR_MIN, PR_MAX,
                                  tx_split)
        geom = chain.geom_for(W, H, MI_COLS, MI_ROWS, 8, tx_split, True, True,
                              PR_MIN, PR_MAX)
        rgeom = rchain.geom_for(W, H, MI_COLS, MI_ROWS, 8, tx_split, True,
                                True, PR_MIN, PR_MAX)
        fields, dcq8, acq8, dbl, y_list, uv_list = _frame_inputs(geom, plan,
                                                                 rng)
        _eq(chain.pack_aux(geom, plan, fields, dcq8, acq8, dbl, y_list,
                           uv_list),
            rchain.pack_aux(rgeom, rplan, fields, dcq8, acq8, dbl, y_list,
                            uv_list))
        eobs = rng.integers(0, 40, plan.n_tx).astype(np.int32)
        levels = rng.integers(-300, 301, int(eobs.sum())).astype(np.int32)
        got = chain.build_coeff_log(plan, eobs, levels)
        want = rchain.build_coeff_log(rplan, eobs, levels)
        _eq(got[0], want[0])
        assert got[1] == want[1]
        sel = {s: rng.integers(0, 5, (geom.gh // s, geom.gw // s)).astype(
            np.int16) for s in geom.sizes}
        for a, b in zip(chain.derive_decisions(geom, plan, sel, fields),
                        rchain.derive_decisions(rgeom, rplan, sel, fields)):
            assert a.dtype == b.dtype
            _eq(a, b)


@pytest.mark.parametrize("w,h", [(128, 96), (136, 88)])
def test_host_planes_and_fields(w, h):
    import rav1e_tpu
    import rav1e_tpu_torch
    from rav1e_tpu.device.analysis import DeviceMaps as RMaps
    from rav1e_tpu_torch.device.analysis import DeviceMaps

    rng = np.random.default_rng(w)
    frames = []
    for pkg in (rav1e_tpu_torch, rav1e_tpu):
        f = pkg.Frame.new(w, h, pkg.ChromaSampling.Cs420, 8)
        frames.append(f)
    for pa, pb in zip(*(f.planes for f in frames)):
        arr = rng.integers(0, 256, (pa.cfg.height, pa.cfg.width)).astype(np.uint8)
        pa.copy_from(arr)
        pb.copy_from(arr)
        pa.pad()
        pb.pad()
    for fn in ("host_pad_planes", "host_src_planes"):
        for a, b in zip(getattr(chain, fn)(frames[0], w, h),
                        getattr(rchain, fn)(frames[1], w, h)):
            assert a.dtype == b.dtype
            _eq(a, b, fn)
    mv = [rng.integers(-900, 900, (8, 10, 2)).astype(np.int32) for _ in range(3)]
    kw = dict(size_log2=None, mode=None, use_inter=None, bits_est=0.0,
              mv0=mv[0], mv1=mv[1], mv2=None)
    _eq(chain.clamp_fields(DeviceMaps(**kw), 6, 8),
        rchain.clamp_fields(RMaps(**kw), 6, 8))


# ---------------------------------------------------------------------------
# the five stages, one geometry, JAX compiled once per module
# ---------------------------------------------------------------------------


def _texture(rng, h, w):
    coarse = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2))
    up = np.repeat(np.repeat(coarse, 8, 0), 8, 1)[:h, :w].astype(np.int32)
    k = np.ones(5) / 5.0
    up = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, up)
    return up


@pytest.fixture(scope="module")
def stage_case():
    """Seeded inputs of one bidirectional inter frame and the reference's
    stage outputs."""
    rng = np.random.default_rng(2024)
    sl = _size_map(rng, MI_COLS, MI_ROWS)
    plan = rchain.build_plan(sl, MI_COLS, MI_ROWS, PR_MIN, PR_MAX, False)
    tplan = chain.build_plan(sl, MI_COLS, MI_ROWS, PR_MIN, PR_MAX, False)
    rgeom = rchain.geom_for(W, H, MI_COLS, MI_ROWS, 8, False, True, True,
                            PR_MIN, PR_MAX)
    geom = chain.geom_for(W, H, MI_COLS, MI_ROWS, 8, False, True, True,
                          PR_MIN, PR_MAX)
    fields, dcq8, acq8, dbl, y_list, uv_list = _frame_inputs(geom, tplan, rng)
    aux = rchain.pack_aux(rgeom, plan, fields, dcq8, acq8, dbl, y_list,
                          uv_list)

    gh, gw = geom.gh, geom.gw
    src = []
    for ph, pw in ((gh, gw), (gh // 2, gw // 2), (gh // 2, gw // 2)):
        tex = _texture(rng, ph, pw)
        src.append(np.clip(tex + rng.integers(-6, 7, tex.shape), 0,
                           255).astype(np.uint8))
    refs = []
    for k in range(3):
        planes = []
        for p, s in enumerate(src):
            shifted = np.roll(s.astype(np.int32), (k + 1) * (1 + p % 2), axis=1)
            noisy = np.clip(shifted + rng.integers(-4, 5, s.shape), 0, 255)
            pad = rchain.PADD
            ry = np.clip(np.arange(s.shape[0] + 2 * pad) - pad, 0,
                         s.shape[0] - 1)
            rx = np.clip(np.arange(s.shape[1] + 2 * pad) - pad, 0,
                         s.shape[1] - 1)
            planes.append(noisy[ry[:, None], rx[None, :]].astype(np.uint8))
        refs.append(tuple(planes))

    f_sel, f_chroma, f_txq, f_filters, f_pack = rchain.chain_stages_jit(rgeom)
    jaux = jnp.asarray(aux)
    jsrc = tuple(jnp.asarray(p) for p in src)
    jrefs = tuple(tuple(jnp.asarray(p) for p in r) for r in refs)
    out = {}
    out["pred_y"], out["sels"] = f_sel(jsrc[0], tuple(r[0] for r in jrefs),
                                       jaux)
    out["pred_u"], out["pred_v"] = f_chroma(
        tuple(r[1] for r in jrefs), tuple(r[2] for r in jrefs), jaux,
        out["sels"])
    (out["levels_flat"], out["eob_ord"], out["overflow"], out["recons"],
     out["skip8"], out["tx8"], out["bsize8"]) = f_txq(
        jsrc, (out["pred_y"], out["pred_u"], out["pred_v"]), jaux)
    out["ref_out"], out["cdef_idx"] = f_filters(
        out["recons"], jsrc, out["skip8"], out["tx8"], out["bsize8"], jaux)
    out["hdr"], out["levels"] = f_pack(out["overflow"], out["eob_ord"],
                                       out["sels"], out["cdef_idx"],
                                       out["levels_flat"])
    out = jax.tree_util.tree_map(np.asarray, out)
    return {"geom": geom, "plan": tplan, "aux": aux, "src": src,
            "refs": refs, "fields": fields, "dbl": dbl, "dcq8": dcq8,
            "acq8": acq8, "y_list": y_list, "uv_list": uv_list, "want": out}


def _inputs(case):
    return (_t(case["aux"]), tuple(_t(p) for p in case["src"]),
            tuple(tuple(_t(p) for p in r) for r in case["refs"]))


def test_stage_sel_luma(stage_case):
    want = stage_case["want"]
    aux, src, refs = _inputs(stage_case)
    f_sel = chain.chain_stages(stage_case["geom"])[0]
    pred_y, sels = f_sel(src[0], tuple(r[0] for r in refs), aux)
    _eq(pred_y, want["pred_y"])
    assert len(sels) == len(want["sels"])
    for a, b in zip(sels, want["sels"]):
        _eq(a, b)
    # the case reaches most candidates, and the forced ties (zero fields:
    # candidates 0 and 3 predict alike) resolve to the first minimum
    allsel = np.concatenate([np.asarray(s).ravel() for s in want["sels"]])
    assert len(set(np.unique(allsel))) >= 4
    s16 = np.asarray(want["sels"][stage_case["geom"].sizes.index(16)])
    ny16, nx16 = s16.shape
    tied = s16[: ny16 // 2, : nx16 // 2]
    assert (tied == 0).any() and not (tied == 3).any()


def test_stage_chroma(stage_case):
    want = stage_case["want"]
    aux, src, refs = _inputs(stage_case)
    f_chroma = chain.chain_stages(stage_case["geom"])[1]
    sels = tuple(_t(s) for s in want["sels"])
    pu, pv = f_chroma(tuple(r[1] for r in refs), tuple(r[2] for r in refs),
                      aux, sels)
    _eq(pu, want["pred_u"])
    _eq(pv, want["pred_v"])


def test_stage_txq(stage_case):
    want = stage_case["want"]
    aux, src, _ = _inputs(stage_case)
    f_txq = chain.chain_stages(stage_case["geom"])[2]
    preds = (_t(want["pred_y"]), _t(want["pred_u"]), _t(want["pred_v"]))
    lf, eo, ov, recons, skip8, tx8, bsize8 = f_txq(src, preds, aux)
    g = stage_case["geom"]
    # the sentinel slots are write-only: compare what is read
    _eq(lf[: g.lcap], want["levels_flat"][: g.lcap], "levels_flat")
    _eq(eo[: g.ntx_cap], want["eob_ord"][: g.ntx_cap], "eob_ord")
    assert int(ov) == int(want["overflow"]) == 0
    for p in range(3):
        _eq(recons[p], want["recons"][p], f"recon {p}")
    _eq(skip8, want["skip8"])
    _eq(tx8, want["tx8"])
    _eq(bsize8, want["bsize8"])
    nz = int((want["eob_ord"][: g.ntx_cap] > 0).sum())
    assert 0 < nz < stage_case["plan"].n_tx  # coded and skipped cells both


def test_stage_filters(stage_case):
    want = stage_case["want"]
    aux, src, _ = _inputs(stage_case)
    f_filters = chain.chain_stages(stage_case["geom"])[3]
    recons = tuple(_t(r) for r in want["recons"])
    before = [r.clone() for r in recons]
    ref_out, cdef_idx = f_filters(
        recons, src, _t(want["skip8"]), _t(want["tx8"]), _t(want["bsize8"]),
        aux, stage_case["y_list"], stage_case["uv_list"])
    for p in range(3):
        _eq(ref_out[p], want["ref_out"][p], f"ref plane {p}")
        assert torch.equal(recons[p], before[p]), "an input was written"
    _eq(cdef_idx, want["cdef_idx"])
    # deblock and CDEF both changed pixels
    assert any(not np.array_equal(
        np.asarray(want["ref_out"][p])[88:-88, 88:-88].astype(np.int32),
        np.asarray(want["recons"][p])) for p in range(3))


def test_stage_pack(stage_case):
    want = stage_case["want"]
    f_pack = chain.chain_stages(stage_case["geom"])[4]
    hdr, levels = f_pack(_t(want["overflow"]), _t(want["eob_ord"]),
                         tuple(_t(s) for s in want["sels"]),
                         _t(want["cdef_idx"]), _t(want["levels_flat"]))
    assert hdr.dtype == levels.dtype == torch.int16
    _eq(hdr, want["hdr"])
    _eq(levels, want["levels"])


def test_dispatch_fetch_on_cpu(stage_case):
    """The whole dispatch on device "cpu" from numpy inputs, then the fetch:
    the host result equals what the reference's payload decodes to."""
    c = stage_case
    g = c["geom"]
    refs = tuple(tuple(_t(p) for p in r) for r in c["refs"])
    handle = chain.dispatch_chain(ChainPrograms("cpu"), g, c["plan"],
                                  c["src"], refs, c["fields"], c["dcq8"],
                                  c["acq8"], c["dbl"], c["y_list"],
                                  c["uv_list"])
    res = chain.fetch_chain(handle)
    hdr = c["want"]["hdr"]
    assert res.overflow is False
    _eq(res.eobs, hdr[1 : 1 + c["plan"].n_tx])
    total = int(hdr[1 : 1 + g.ntx_cap].astype(np.int64).sum())
    _eq(res.levels, c["want"]["levels"][:total])
    for p in range(3):
        _eq(res.refs[p], c["want"]["ref_out"][p])
    assert sorted(res.sel) == list(g.sizes)
    _eq(res.cdef_idx, c["want"]["cdef_idx"])

