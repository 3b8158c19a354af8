"""The filter stage's kernels on the CPU, the port alone: csrc/cdef.cu's
``cdef_dirs``, ``cdef_search`` and ``cdef_apply`` and csrc/deblock.cu's
``deblock_edges``, through their plain versions.

The kernels run only on a card (chip_smoke.py holds each equal to its plain
version there).  Here: the composition of the plain versions equals the
stage as it was written before the kernels (a frozen copy below) at every
bit depth, chroma layout and edge case of the CDEF stage, and the plain
deblock pass equals the pass as it was at every filter size; the wrappers'
input checks; a CPU tensor takes the plain version and launches nothing;
a stage-4 run counts one launch per wrapper call into a capture's tally;
and the stage-4 body reads no device value on the host after its first
run.  The reference package is held against the same plain versions in
tests/test_torch_filters.py and tests/test_torch_dsp.py."""

import numpy as np
import pytest
import torch
from host_reads import HostReads
from torch_threads import one_torch_cpu_thread  # noqa: F401

from rav1e_tpu_torch.device import chain, dsp, filters, kernels
from rav1e_tpu_torch.device.filters import (
    _cell_windows, _msb, _ring_mask, _tables, cdef_dirs_cells,
    cdef_filter_from_taps, cdef_tap_precompute, CDEF_SEC_STRENGTHS,
)

_I64 = torch.int64


def frozen_cdef_stage_core(planes, grid, damping, bd, rec_grids, src_grids,
                           filt, y_str, uv_str):
    """filters.cdef_stage_core as it was before its kernels, verbatim."""
    nby, nbx, sb_rows, sb_cols, crop_w, crop_h = grid
    ncand = len(y_str)
    dev = filt.device
    by = torch.arange(nby, device=dev)
    bx = torch.arange(nbx, device=dev)
    coeff_shift = bd - 8

    have_top = (by > 0)[:, None].expand(nby, nbx)
    have_left = (bx > 0)[None, :].expand(nby, nbx)
    have_right = (((bx + 2) * 8) <= crop_w)[None, :].expand(nby, nbx)
    have_bottom = (((by + 2) * 8) <= crop_h)[:, None].expand(nby, nbx)

    rec_grids = [g.to(_I64) for g in rec_grids]
    src_grids = [g.to(_I64) for g in src_grids]

    ys0, xs0 = planes[0][0], planes[0][1]
    luma = rec_grids[0][2 : 2 + nby * ys0, 2 : 2 + nbx * xs0]
    cells = luma.reshape(nby, ys0, nbx, xs0).permute(0, 2, 1, 3)
    dirs, variances = cdef_dirs_cells(cells, bd)
    var6 = variances >> 6
    var_idx = torch.where(var6 != 0, _msb(var6.clamp(min=1)).clamp(max=12), 0)

    sse = torch.zeros((ncand, nby, nbx), dtype=_I64, device=dev)
    cand_cells = []
    for pi, (ys, xs, vh, vw) in enumerate(planes):
        win = _cell_windows(rec_grids[pi], nby, nbx, ys, xs)
        win = _ring_mask(win, have_top, have_left, have_right, have_bottom)
        src = src_grids[pi].reshape(nby, ys, nbx, xs).permute(0, 2, 1, 3)
        rows_in = ((by[:, None] * ys + torch.arange(ys, device=dev)[None, :])
                   < vh)[:, None, :, None]
        cols_in = ((bx[:, None] * xs + torch.arange(xs, device=dev)[None, :])
                   < vw)[None, :, None, :]
        inside = rows_in & cols_in

        damp = damping + coeff_shift - (0 if pi == 0 else 1)
        if pi > 0 and ys != xs:
            base_dir = _tables(dev).cdef_uv_dir_422[dirs]
        else:
            base_dir = dirs
        taps_dir = cdef_tap_precompute(win, base_dir)
        taps_0 = cdef_tap_precompute(win, 0)
        plane_cands = []
        for ci in range(ncand):
            v = y_str[ci] if pi == 0 else uv_str[ci]
            pri_u = v // CDEF_SEC_STRENGTHS
            sec_u = v % CDEF_SEC_STRENGTHS
            sec_u += sec_u == 3
            sec_s = sec_u << coeff_shift
            if pri_u == 0:
                p0 = torch.zeros_like(dirs)
            elif pi == 0:
                strength = pri_u << coeff_shift
                p0 = torch.where(variances != 0,
                                 (strength * (4 + var_idx) + 8) >> 4, 0)
            else:
                p0 = torch.full_like(dirs, pri_u << coeff_shift)
            taps = taps_dir if pri_u != 0 else taps_0
            fcells = cdef_filter_from_taps(taps, p0, sec_s, damp, bd)
            plane_cands.append(fcells)
            d = torch.where(inside, fcells - src, 0)
            cell_sse = (d * d).sum(dim=(-1, -2))
            sse[ci] += torch.where(filt, cell_sse, 0)
        cand_cells.append(torch.stack(plane_cands))

    pad_y = sb_rows * 8 - nby
    pad_x = sb_cols * 8 - nbx
    sse = torch.nn.functional.pad(sse, (0, pad_x, 0, pad_y))
    sb = sse.reshape(ncand, sb_rows, 8, sb_cols, 8).sum(dim=(2, 4))
    idx = torch.argmin(sb, dim=0)

    cell_idx = idx[(by // 8).clamp(max=sb_rows - 1)][
        :, (bx // 8).clamp(max=sb_cols - 1)
    ]
    outs = []
    for pi, (ys, xs, vh, vw) in enumerate(planes):
        cands = cand_cells[pi]
        chosen = torch.gather(
            cands, 0, cell_idx[None, :, :, None, None].expand(1, nby, nbx, ys, xs)
        )[0]
        pre_cells = (
            rec_grids[pi][2 : 2 + nby * ys, 2 : 2 + nbx * xs]
            .reshape(nby, ys, nbx, xs)
            .permute(0, 2, 1, 3)
        )
        final = torch.where(filt[..., None, None], chosen, pre_cells)
        outs.append(final.permute(0, 2, 1, 3).reshape(nby * ys, nbx * xs))
    return outs, idx


def _stage_inputs(seed, w, h, bd, dec, skip=0.5, lists=None, damping=3,
                  smooth=False):
    """Seeded inputs of cdef_stage_core for a w x h frame: the planes'
    grids with their 2px ring, the source, a skip map and strength lists
    (``dec``: chroma (xdec, ydec), None for luma alone)."""
    rng = np.random.default_rng(seed)
    nby, nbx = -(-h // 8), -(-w // 8)
    planes, rec, src = [], [], []
    for xd, yd in [(0, 0)] + ([dec, dec] if dec else []):
        ys, xs = 8 >> yd, 8 >> xd
        planes.append((ys, xs, (h + (1 << yd) - 1) >> yd,
                       (w + (1 << xd) - 1) >> xd))
        shape = (nby * ys + 4, nbx * xs + 4)
        if smooth:  # near-flat: the filters act and the clamps bind
            r = rng.integers(0, 1 << bd) + rng.integers(
                -6 << (bd - 8), 7 << (bd - 8), shape)
        else:
            r = rng.integers(0, 1 << bd, shape)
        r = np.clip(r, 0, (1 << bd) - 1)
        s = np.clip(r[2:-2, 2:-2] + rng.integers(-40, 41, r[2:-2, 2:-2].shape),
                    0, (1 << bd) - 1)
        rec.append(torch.from_numpy(r.astype(np.int32)))
        src.append(torch.from_numpy(s.astype(np.int32)))
    filt = torch.from_numpy(rng.random((nby, nbx)) >= skip)
    if lists is None:
        lists = filters._strength_lists(int(rng.integers(1, 64)),
                                        int(rng.integers(0, 64)))
    grid = (nby, nbx, -(-h // 64), -(-w // 64), w, h)
    return (planes, grid, damping, bd, rec, src, filt, list(lists[0]),
            list(lists[1]))


CDEF_CASES = {
    "8-bit 4:2:0": dict(seed=1, w=72, h=64, bd=8, dec=(1, 1)),
    "10-bit 4:2:2": dict(seed=2, w=72, h=64, bd=10, dec=(1, 0), smooth=True),
    "12-bit 4:4:4": dict(seed=3, w=72, h=64, bd=12, dec=(0, 0), damping=6),
    "ragged 4:2:0": dict(seed=4, w=75, h=61, bd=8, dec=(1, 1), smooth=True),
    "luma only": dict(seed=5, w=64, h=40, bd=10, dec=None),
    "all skip": dict(seed=6, w=64, h=64, bd=8, dec=(1, 1), skip=1.0),
    # pri 0 candidates (direction-0 taps) and sec 3 (filtered as 4)
    "pri 0, sec 3": dict(seed=7, w=72, h=40, bd=8, dec=(1, 1), smooth=True,
                         lists=([0, 3, 7, 63], [3, 0, 1, 60])),
    # every candidate the identity: equal SSEs, ties to index 0
    "ties": dict(seed=8, w=72, h=72, bd=12, dec=(0, 0), skip=0.0,
                 lists=([0, 0, 0, 0], [0, 0, 0, 0])),
}


@pytest.mark.parametrize("name", list(CDEF_CASES))
def test_plain_versions_compose_the_stage_as_it_was(name):
    args = _stage_inputs(**CDEF_CASES[name])
    outs, idx = filters.cdef_stage_core(*args)
    want_outs, want_idx = frozen_cdef_stage_core(*args)
    assert idx.dtype == _I64 and torch.equal(idx, want_idx)
    assert len(outs) == len(want_outs)
    for got, want in zip(outs, want_outs):
        assert got.dtype == _I64 and torch.equal(got, want)
    if name == "ties":
        assert not idx.any()
    if name == "all skip":
        for got, rec in zip(outs, args[4]):
            assert torch.equal(got, rec[2:-2, 2:-2].to(_I64))


def test_source_outside_the_crop_changes_nothing():
    """Ragged crop: the source samples past vis_h/vis_w (in the last row
    and column of cells and the partial superblocks) are outside every
    SSE, so garbage there changes no SSE, index or plane."""
    args = _stage_inputs(**CDEF_CASES["ragged 4:2:0"])
    planes, grid, _damping, bd, rec, src, filt = args[:7]
    nby, nbx = grid[:2]
    garbage = []
    for (ys, xs, vh, vw), s in zip(planes, src):
        g = s.clone()
        g[vh:] = (1 << bd) - 1
        g[:, vw:] = torch.arange(nbx * xs - vw) * 1000 % (1 << bd)
        assert vh < nby * ys and vw < nbx * xs and not torch.equal(g, s)
        garbage.append(g)
    dirs, var = filters.cdef_dirs(rec[0], nby, nbx, bd)
    search = (args[0], grid, args[2], bd, rec)
    rest = (filt, dirs, var, args[7], args[8])
    want = filters.cdef_search(*search, src, *rest)
    assert torch.equal(filters.cdef_search(*search, garbage, *rest), want)
    got = filters.cdef_stage_core(*args[:5], garbage, *args[6:])
    want_outs, want_idx = frozen_cdef_stage_core(*args)
    assert torch.equal(got[1], want_idx)
    assert all(torch.equal(a, b) for a, b in zip(got[0], want_outs))


def test_search_sums_sse_past_31_bits():
    """12-bit 4:4:4 cells as far from their source as samples go: each
    cell's SSE is 192 * 4095^2 = 3,219,651,200 > 2^31, exactly, and so is
    the superblock sum the argmin reads."""
    planes, grid, damping, bd, rec, src, filt, _y, _uv = _stage_inputs(
        9, 64, 64, 12, (0, 0), skip=0.0)
    rec = [torch.zeros_like(r) for r in rec]
    src = [torch.full_like(s, 4095) for s in src]
    dirs, var = filters.cdef_dirs(rec[0], grid[0], grid[1], bd)
    sse = filters.cdef_search(planes, grid, damping, bd, rec, src, filt,
                              dirs, var, [0, 1], [0, 1])
    assert sse.dtype == _I64
    assert (sse == 192 * 4095 ** 2).all()


def test_apply_takes_the_first_of_equal_superblock_sses():
    planes, grid, damping, bd, rec, src, filt, y, uv = _stage_inputs(
        10, 128, 64, 8, (1, 1), skip=0.0)
    dirs, var = filters.cdef_dirs(rec[0], grid[0], grid[1], bd)
    sse = torch.full((4, grid[0], grid[1]), 7, dtype=_I64)
    sse[0, :, :8] += 1      # SB 0: candidates 1-3 tie, 1 wins
    sse[3, :, 8:] -= 1      # SB 1: candidate 3 alone
    _outs, idx = filters.cdef_apply(planes, grid, damping, bd, rec, filt,
                                    dirs, var, sse, y, uv)
    assert idx.tolist() == [[1, 3]]


# ---------------------------------------------------------------------------
# deblock
# ---------------------------------------------------------------------------


def frozen_deblock_pass(rec, fsize_grid, level, bd, vertical):
    """dsp.deblock_pass_device as it was before its kernel, verbatim."""
    pad = 8
    rows_p, cols_p = fsize_grid.shape
    out = rec.clone()
    if vertical:
        ph, n = 4 * rows_p, cols_p
        taps = [rec[pad : pad + ph, pad - 7 + k : pad - 7 + k + 4 * n : 4]
                for k in range(14)]
        fs = fsize_grid[:, None, :].expand(rows_p, 4, cols_p).reshape(ph, n)
        mods = dsp.deblock_taps14(taps, level, bd, fs)
        for k in range(1, 13):
            delta = torch.where(fs != 0, mods[k - 1] - taps[k], 0)
            out[pad : pad + ph, pad - 7 + k : pad - 7 + k + 4 * n : 4] += delta
        return out
    pw, n = 4 * cols_p, rows_p
    taps = [rec[pad - 7 + k : pad - 7 + k + 4 * n : 4, pad : pad + pw]
            for k in range(14)]
    fs = fsize_grid[:, :, None].expand(rows_p, cols_p, 4).reshape(n, pw)
    mods = dsp.deblock_taps14(taps, level, bd, fs)
    for k in range(1, 13):
        delta = torch.where(fs != 0, mods[k - 1] - taps[k], 0)
        out[pad - 7 + k : pad - 7 + k + 4 * n : 4, pad : pad + pw] += delta
    return out


def _deblock_inputs(seed, bd, size):
    """A plane of near-flat rows (the wide filters' flatness tests pass)
    and noisy rows, padded by 8, with edge sizes ``size`` on a checker of
    edges (or a mix of every size when ``size`` is None)."""
    rng = np.random.default_rng(seed)
    rows_p, cols_p = 10, 12
    h, w = 4 * rows_p + 16, 4 * cols_p + 16
    plane = rng.integers(0, 1 << bd, (h, w))
    flat = rng.integers(0, 1 << bd) + rng.integers(0, 2, (h // 2, w))
    flat[:, ::8] += 3 << (bd - 8)  # steps at every other edge
    plane[: h // 2] = np.clip(flat, 0, (1 << bd) - 1)
    if size is None:
        fs = rng.choice([0, 4, 6, 8, 14], (rows_p, cols_p))
    else:
        fs = np.where(rng.random((rows_p, cols_p)) < 0.7, size, 0)
    return (torch.from_numpy(plane.astype(np.int32)),
            torch.from_numpy(fs.astype(np.int32)))


@pytest.mark.parametrize("size", [4, 6, 8, 14, None])
@pytest.mark.parametrize("bd", [8, 10, 12])
def test_plain_deblock_pass_is_the_pass_as_it_was(size, bd):
    plane, fs = _deblock_inputs(size or 1, bd, size)
    before = plane.clone()
    for vertical in (True, False):
        for level in (6, 40, torch.tensor(63, dtype=torch.int32)):
            got = dsp.deblock_pass_device(plane, fs, level, bd, vertical)
            want = frozen_deblock_pass(plane, fs, level, bd, vertical)
            assert torch.equal(got, want)
            assert torch.equal(dsp.deblock_pass_plain(plane, fs, level, bd,
                                                      vertical), want)
    assert not torch.equal(got, plane)
    assert torch.equal(plane, before)


# ---------------------------------------------------------------------------
# wrappers: checks, dispatch, counts, capturability
# ---------------------------------------------------------------------------


def _valid_search_args():
    planes, grid, damping, bd, rec, src, filt, y, uv = _stage_inputs(
        11, 24, 16, 8, (1, 1))
    dirs, var = filters.cdef_dirs(rec[0], grid[0], grid[1], bd)
    return dict(name="cdef_search", planes=planes, grid=grid, bd=bd,
                rec_grids=rec, src_grids=src, filt=filt, dirs=dirs, var=var,
                y_str=y, uv_str=uv)


def _bad_search_args():
    a = _valid_search_args()
    rec, src = a["rec_grids"], a["src_grids"]
    return {
        "int64 grid": (TypeError, {"rec_grids": [rec[0].long(), *rec[1:]]}),
        "grid shape": (ValueError, {"rec_grids": [rec[0][:-1], *rec[1:]]}),
        "strided source": (ValueError,
                           {"src_grids": [src[0].t().contiguous().t(),
                                          *src[1:]]}),
        "int filt": (TypeError, {"filt": a["filt"].to(torch.int32)}),
        "int64 dirs": (TypeError, {"dirs": a["dirs"].long()}),
        "five candidates": (ValueError, {"y_str": [0] * 5,
                                         "uv_str": [0] * 5}),
        "strength 64": (ValueError, {"y_str": [64, 0, 0, 0]}),
        "bit depth 9": (ValueError, {"bd": 9}),
        "two planes": (ValueError, {"planes": a["planes"][:2],
                                    "rec_grids": rec[:2]}),
        "luma cells 4x4": (ValueError,
                           {"planes": [(4, 4, 16, 24), *a["planes"][1:]]}),
        "meta filt": (ValueError, {"filt": a["filt"].to("meta")}),
    }


@pytest.mark.parametrize("what", list(_bad_search_args()))
def test_cdef_input_checks(what):
    filters.check_cdef_inputs(**_valid_search_args())
    err, change = _bad_search_args()[what]
    with pytest.raises(err):
        filters.check_cdef_inputs(**{**_valid_search_args(), **change})


def test_deblock_input_checks():
    plane, fs = _deblock_inputs(0, 8, 4)
    level = torch.tensor(9, dtype=torch.int32)
    dsp.check_deblock_inputs(plane, fs, level, 8)
    dsp.check_deblock_inputs(plane, fs, 9, 8)
    for args, err in (
        ((plane.long(), fs, level, 8), TypeError),
        ((plane, fs.long(), level, 8), TypeError),
        ((plane, fs, level.long(), 8), TypeError),
        ((plane, fs, level[None], 8), ValueError),
        ((plane[:-1], fs, level, 8), ValueError),
        ((plane[:, 1:], fs, level, 8), ValueError),
        ((plane, fs, level, 11), ValueError),
    ):
        with pytest.raises(err):
            dsp.check_deblock_inputs(*args)


def test_wrappers_refuse_a_device_without_kernel():
    meta = torch.empty((20, 28), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        dsp.deblock_pass_device(meta, meta[:1, :3], 9, 8, True)
    with pytest.raises(ValueError, match="no kernel"):
        filters.cdef_dirs(meta, 2, 3, 8)
    a = _valid_search_args()
    meta_args = {k: (v.to("meta") if isinstance(v, torch.Tensor)
                     else [t.to("meta") for t in v]
                     if k.endswith("grids") else v) for k, v in a.items()}
    del meta_args["name"]
    meta_args["damping"] = 3
    with pytest.raises(ValueError, match="no kernel"):
        filters.cdef_search(**meta_args)
    sse = torch.empty((4, *a["filt"].shape), dtype=_I64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        filters.cdef_apply(meta_args["planes"], meta_args["grid"], 3, 8,
                           meta_args["rec_grids"], meta_args["filt"],
                           meta_args["dirs"], meta_args["var"], sse,
                           a["y_str"], a["uv_str"])


def _stage4(f):
    """The chain's stage-4 call of frame ``f`` and its inputs, after
    stages 1-3 ran on the CPU."""
    from test_torch_chain_graphs import _aux

    d = {"src": tuple(torch.from_numpy(p) for p in f["src"]),
         "refs": f["refs"], "aux": torch.from_numpy(_aux(f))}
    calls = chain.stage_calls(f["geom"], f["y_list"], f["uv_list"])
    for names, call in calls[:3]:
        d.update(zip(names, call(d)))
    return calls[3][1], d


@pytest.fixture(scope="module")
def stage4():
    from test_torch_chain_graphs import Q_OTHER, _frame

    return _stage4(_frame(64, 64, 10, Q_OTHER))


def test_cpu_stage_launches_nothing(stage4):
    call, d = stage4
    kernels.reset_launches()
    call(d)
    args = _stage_inputs(**CDEF_CASES["8-bit 4:2:0"])
    filters.cdef_stage_core(*args)
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)


def test_stage4_counts_each_wrapper_call_into_a_capture_tally(monkeypatch,
                                                              stage4):
    """Each wrapper counts where it would launch: with the CPU branch made
    to count as the kernel does, a stage-4 run inside counting_capture
    tallies six deblock passes (3 planes x 2 orientations) and one launch
    of each CDEF kernel, and LAUNCHES moves only when the tally is added,
    as at a graph replay."""
    for mod, plain, name in ((dsp, "deblock_pass_plain", "deblock_edges"),
                             (filters, "cdef_dirs_plain", "cdef_dirs"),
                             (filters, "cdef_search_plain", "cdef_search"),
                             (filters, "cdef_apply_plain", "cdef_apply")):
        real = getattr(mod, plain)

        def counted(*a, _real=real, _name=name):
            kernels._count(_name)
            return _real(*a)

        monkeypatch.setattr(mod, plain, counted)
    call, d = stage4
    kernels.reset_launches()
    with kernels.counting_capture() as tally:
        call(d)
    want = {"deblock_edges": 6, "cdef_dirs": 1, "cdef_search": 1,
            "cdef_apply": 1}
    assert tally == {**dict.fromkeys(kernels.LAUNCHES, 0), **want}
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)
    kernels.add_launches(tally)
    kernels.add_launches(tally)
    assert {k: kernels.LAUNCHES[k] for k in want} == {
        k: 2 * v for k, v in want.items()}
    kernels.reset_launches()


def test_stage4_reads_nothing_on_the_host_after_its_first_run(stage4):
    call, d = stage4
    want = call(d)  # the first run makes the stage's device constants
    with HostReads() as mode:
        got = call(d)
    assert mode.found == []
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    assert torch.equal(got[1], want[1])
