"""rav1e_tpu_torch device CDEF stage against rav1e_tpu's device stage and
against the host ops.cdef search + apply: the same per-SB strength map and
the same filtered planes, exactly (tests/test_device_filters.py's cases and
fixture)."""

import copy

import numpy as np
import pytest

import rav1e_tpu.ops.cdef as cdef_mod
import rav1e_tpu_torch
from rav1e_tpu.config import ChromaSampling
from rav1e_tpu.frame import Frame
from rav1e_tpu_torch.device import kernels
from torch_threads import one_torch_cpu_thread  # noqa: F401


class _Blocks:
    pass


def _mk(rng, W, H, bd, cs):
    dt = np.uint8 if bd == 8 else np.uint16
    rec = Frame.new(W, H, cs, bd)
    src = Frame.new(W, H, cs, bd)
    for f in (rec, src):
        for p in f.planes:
            arr = rng.integers(0, 1 << bd, (p.cfg.height, p.cfg.width))
            p.copy_from(arr.astype(dt))
            p.pad()
    mi_cols, mi_rows = -(-W // 4), -(-H // 4)
    blocks = _Blocks()
    blocks.cols, blocks.rows = mi_cols, mi_rows
    blocks.skip = rng.integers(0, 2, (mi_rows, mi_cols)).astype(bool)
    return rec, src, blocks


def _to_port(frame, W, H, bd, cs):
    """The port's own Frame holding the same samples: a rav1e_tpu Frame is
    another class."""
    out = rav1e_tpu_torch.Frame.new(W, H, rav1e_tpu_torch.ChromaSampling(int(cs)),
                                    bd)
    for q, p in zip(out.planes, frame.planes):
        assert q.data.shape == p.data.shape
        q.data[...] = p.data
    return out


def _clone(frame):
    out = copy.copy(frame)
    out.planes = []
    for p in frame.planes:
        q = copy.copy(p)
        q.data = p.data.copy()
        out.planes.append(q)
    return out


@pytest.mark.parametrize(
    "bd,cs",
    [
        (8, ChromaSampling.Cs420),
        (10, ChromaSampling.Cs422),
        (12, ChromaSampling.Cs444),
    ],
)
def test_cdef_device_frame_matches_reference(bd, cs):
    from rav1e_tpu.device.filters import cdef_device_frame as ref_cdef
    from rav1e_tpu_torch.device.filters import cdef_device_frame

    rng = np.random.default_rng(11)
    W, H = 136, 88
    rec, src, blocks = _mk(rng, W, H, bd, cs)
    damping, base_y, base_uv = 3, 9, 5

    host_rec = _clone(rec)
    ys_h, us_h, idx_h, state = cdef_mod.cdef_rdo_frame(
        host_rec, src, blocks, bd, cs, W, H, damping, base_y, base_uv
    )
    cdef_mod.cdef_filter_frame(
        (damping, ys_h, us_h), host_rec, blocks, bd, cs, W, H,
        cdef_idx_map=idx_h, state=state,
    )
    jax_rec = _clone(rec)
    ys_j, us_j, idx_j, _ = ref_cdef(jax_rec, src, blocks, bd, cs, W, H,
                                    damping, base_y, base_uv)

    port_rec = _to_port(rec, W, H, bd, cs)
    kernels.reset_launches()
    ys_t, us_t, idx_t, applied = cdef_device_frame(
        port_rec, _to_port(src, W, H, bd, cs), blocks, bd,
        rav1e_tpu_torch.ChromaSampling(int(cs)), W, H, damping, base_y,
        base_uv, device="cpu",
    )
    assert applied
    # the stage's plain versions (filters.cdef_dirs_plain, cdef_search_plain,
    # cdef_apply_plain) ran: a CPU tensor launches no kernel
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)
    assert ys_t == ys_h == ys_j and us_t == us_h == us_j
    assert idx_t.dtype == np.int32
    np.testing.assert_array_equal(idx_t, idx_h)
    np.testing.assert_array_equal(idx_t, idx_j)
    for pi in range(len(rec.planes)):
        np.testing.assert_array_equal(port_rec.planes[pi].data,
                                      host_rec.planes[pi].data)
        np.testing.assert_array_equal(port_rec.planes[pi].data,
                                      jax_rec.planes[pi].data)


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_cdef_cells_match_reference(bd):
    """The direction search and the filter core on a small cell grid, with
    CDEF_VERY_LARGE rings on some cells, against rav1e_tpu's, exactly."""
    import jax.numpy as jnp
    import torch

    from rav1e_tpu.device import filters as ref
    from rav1e_tpu_torch.device import filters as port

    rng = np.random.default_rng(20 + bd)
    nby, nbx = 3, 4
    win = rng.integers(0, 1 << bd, (nby, nbx, 12, 12)).astype(np.int32)
    win[0, :, :2, :] = cdef_mod.CDEF_VERY_LARGE  # top ring of the first row
    win[:, -1, :, -2:] = cdef_mod.CDEF_VERY_LARGE  # right ring of the last col
    dirs = rng.integers(0, 8, (nby, nbx)).astype(np.int32)
    pri = (rng.integers(0, 16, (nby, nbx)) << (bd - 8)).astype(np.int32)
    for sec in (0, 1 << (bd - 8), 4 << (bd - 8)):
        want = np.asarray(ref.cdef_filter_cells(
            jnp.asarray(win), jnp.asarray(dirs), jnp.asarray(pri), sec,
            5 + bd - 8, bd))
        got = port.cdef_filter_cells(
            torch.from_numpy(win).long(), torch.from_numpy(dirs).long(),
            torch.from_numpy(pri).long(), sec, 5 + bd - 8, bd).numpy()
        np.testing.assert_array_equal(got, want)

    cells = win[..., 2:10, 2:10]
    want_dir, want_var = map(np.asarray, ref.cdef_dirs_cells(
        jnp.asarray(cells), bd))
    got_dir, got_var = port.cdef_dirs_cells(torch.from_numpy(cells), bd)
    np.testing.assert_array_equal(got_dir.numpy(), want_dir)
    np.testing.assert_array_equal(got_var.numpy(), want_var)
    # the plain version of csrc/cdef.cu's cdef_dirs, on the cells' plane
    # with its 2px ring
    plane = np.pad(cells.transpose(0, 2, 1, 3).reshape(nby * 8, nbx * 8), 2)
    got_dir, got_var = port.cdef_dirs_plain(torch.from_numpy(plane), nby,
                                            nbx, bd)
    np.testing.assert_array_equal(got_dir.numpy(), want_dir)
    np.testing.assert_array_equal(got_var.numpy(), want_var)


def test_cdef_device_frame_all_skip():
    from rav1e_tpu_torch.device.filters import cdef_device_frame

    rng = np.random.default_rng(3)
    cs = ChromaSampling.Cs420
    rec, src, blocks = _mk(rng, 64, 64, 8, cs)
    rec, src = _to_port(rec, 64, 64, 8, cs), _to_port(src, 64, 64, 8, cs)
    blocks.skip[:] = True
    before = [p.data.copy() for p in rec.planes]
    ys, us, idx, applied = cdef_device_frame(
        rec, src, blocks, 8, rav1e_tpu_torch.ChromaSampling.Cs420, 64, 64, 3,
        9, 5, device="cpu",
    )
    assert not applied
    assert np.all(idx == 0)
    for p, b in zip(rec.planes, before):
        np.testing.assert_array_equal(p.data, b)
