"""rav1e_tpu_torch.device.graphs.ChainPrograms on the CPU, the port alone.

On a card the runner replays five CUDA graphs per (geometry, CDEF lists)
key; on the CPU it runs the same stages eagerly into the same static
buffers and copies out the same outputs, so these tests see what a replay
would leave behind: the runner equals ``chain.run_stages``, results already
handed out survive later dispatches (a speculative one included), each CDEF
list pair is a key of its own, and after a key's first frame the stages
read no device value on the host and make no tensor from host data, which a
capture could not do.  The card runs the graphs in chip_smoke.py's
chain-stages and slice phases."""

import numpy as np
import pytest
import torch
from host_reads import HostReads
from torch_threads import one_torch_cpu_thread  # noqa: F401

from rav1e_tpu_torch import tables
from rav1e_tpu_torch.device import chain, constants
from rav1e_tpu_torch.device.filters import _strength_lists
from rav1e_tpu_torch.device.graphs import ChainPrograms
from rav1e_tpu_torch.ops.cdef import cdef_strengths_fast

# q 170 at 192x128 codes 9,276 levels: more than the 8,192 of the smallest
# levels prefix, fewer than the 12,288 of the levels budget, so a fetch
# after a low level-count hint reads the device levels buffer
Q_FALLBACK, Q_OTHER = 170, 200


def _texture(rng, h, w):
    coarse = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2))
    up = np.repeat(np.repeat(coarse, 8, 0), 8, 1)[:h, :w].astype(np.float64)
    k = np.ones(5) / 5.0
    return np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, up)


def _geom(w, h):
    mi_cols, mi_rows = 2 * ((w + 7) >> 3), 2 * ((h + 7) >> 3)
    return chain.geom_for(w, h, mi_cols, mi_rows, 8, False, True, True, 3, 6)


def _frame(w, h, seed, q):
    """Seeded inputs of one bidirectional inter frame as dispatch_chain
    takes them: numpy source planes, device (here CPU) reference planes."""
    rng = np.random.default_rng(seed)
    g = _geom(w, h)
    nby, nbx = g.gh // 8, g.gw // 8
    plan = chain.build_plan(rng.integers(3, 7, (nby, nbx)).astype(np.int32),
                            g.mi_cols, g.mi_rows, 3, 6, False)
    fields = rng.integers(-96, 97, (3, g.gh // 16, g.gw // 16, 2)).astype(
        np.int32)
    dcq8 = np.full((3, nby, nbx), tables.dc_q(q, 0, 8), np.int32)
    acq8 = np.full((3, nby, nbx), tables.ac_q(q, 0, 8), np.int32)
    y_list, uv_list = _strength_lists(
        *cdef_strengths_fast(tables.ac_q(q, 0, 8)))
    src = [np.clip(_texture(rng, ph, pw) + rng.integers(-6, 7, (ph, pw)), 0,
                   255).astype(np.uint8)
           for ph, pw in ((g.gh, g.gw), (g.gh // 2, g.gw // 2),
                          (g.gh // 2, g.gw // 2))]
    pad = chain.PADD
    refs = []
    for k in range(3):
        planes = []
        for s in src:
            shifted = np.roll(s.astype(np.int32), k + 1, axis=1)
            noisy = np.clip(shifted + rng.integers(-4, 5, s.shape), 0, 255)
            ry = np.clip(np.arange(s.shape[0] + 2 * pad) - pad, 0,
                         s.shape[0] - 1)
            rx = np.clip(np.arange(s.shape[1] + 2 * pad) - pad, 0,
                         s.shape[1] - 1)
            planes.append(torch.from_numpy(
                noisy[ry[:, None], rx[None, :]].astype(np.uint8)))
        refs.append(tuple(planes))
    return {"geom": g, "plan": plan, "src": src, "refs": tuple(refs),
            "fields": fields, "dcq8": dcq8, "acq8": acq8,
            "dbl": [24, 20, 12, 10], "y_list": y_list, "uv_list": uv_list}


def _aux(f):
    return chain.pack_aux(f["geom"], f["plan"], f["fields"], f["dcq8"],
                          f["acq8"], f["dbl"], f["y_list"], f["uv_list"])


def _eager(f, refs=None):
    """(ref_out, hdr, levels) of chain.run_stages on fresh tensors."""
    return chain.run_stages(
        f["geom"], tuple(torch.from_numpy(p) for p in f["src"]),
        f["refs"] if refs is None else refs, torch.from_numpy(_aux(f)),
        f["y_list"], f["uv_list"])


def _dispatch(programs, f, refs=None):
    return chain.dispatch_chain(
        programs, f["geom"], f["plan"], f["src"],
        f["refs"] if refs is None else refs, f["fields"], f["dcq8"],
        f["acq8"], f["dbl"], f["y_list"], f["uv_list"])


def _check_result(res, f, want):
    """A fetched ChainResult against the eager (ref_out, hdr, levels)."""
    g = f["geom"]
    ref_out, hdr, levels = (tuple(t.numpy() for t in want[0]),
                            want[1].numpy(), want[2].numpy())
    assert res.overflow == bool(hdr[0])
    np.testing.assert_array_equal(res.eobs, hdr[1 : 1 + f["plan"].n_tx])
    total = int(hdr[1 : 1 + g.ntx_cap].astype(np.int64).sum())
    np.testing.assert_array_equal(res.levels, levels[:total])
    for p in range(3):
        np.testing.assert_array_equal(res.refs[p].numpy(), ref_out[p])
    sb = ((g.vis_h + 63) // 64) * ((g.vis_w + 63) // 64)
    np.testing.assert_array_equal(res.cdef_idx.ravel(), hdr[-sb:])


@pytest.mark.parametrize("w,h", [(64, 64), (192, 128)])
def test_runner_equals_eager_stages(w, h):
    """Two frames of one key: the first makes the static outputs, the
    second overwrites them; each equals run_stages on its own inputs."""
    programs = ChainPrograms("cpu")
    for seed in (1, 2):
        f = _frame(w, h, seed, Q_OTHER)
        got = programs.run(f["geom"], f["src"], f["refs"], _aux(f),
                           f["y_list"], f["uv_list"])
        want = _eager(f)
        for a, b in zip(got[0], want[0]):
            assert torch.equal(a, b)
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[2], want[2])
    f = _frame(w, h, 1, Q_OTHER)
    assert programs.stats() == {
        "keys": 1, "captured": 0, "eager": 2, "captures": 0, "replays": 0,
        "pool_bytes": 0,
        "by_key": [(True, True, tuple(f["y_list"]), tuple(f["uv_list"]), 2,
                    0)]}


def test_back_to_back_dispatches_keep_their_results(monkeypatch):
    """Two dispatches of one key, both fetched afterwards, the first
    through the device levels buffer: each gives its own results."""
    a, b = _frame(192, 128, 3, Q_FALLBACK), _frame(192, 128, 4, Q_FALLBACK)
    monkeypatch.setitem(chain._LVL_TOTAL_HINT, a["geom"], 0)
    programs = ChainPrograms("cpu")
    ha = _dispatch(programs, a)
    hb = _dispatch(programs, b)
    want_a = _eager(a)
    total_a = int(want_a[1][1 : 1 + a["geom"].ntx_cap].to(torch.int64).sum())
    pre_host = ha[3][1]
    assert pre_host.shape[0] < total_a <= a["geom"].lcap
    _check_result(chain.fetch_chain(ha), a, want_a)
    _check_result(chain.fetch_chain(hb), b, _eager(b))


def test_discarded_speculative_dispatch_changes_nothing_handed_out():
    """As the pipeline does it: frame N dispatched, frame N+1 dispatched
    early against N's reconstruction, that early dispatch discarded and
    N+1 dispatched afresh with other inputs.  N's results, and the fresh
    dispatch's, are each their own."""
    n, early, fresh = (_frame(192, 128, s, Q_OTHER) for s in (5, 6, 7))
    programs = ChainPrograms("cpu")
    hn = _dispatch(programs, n)
    refs_next = (hn[2], n["refs"][1], n["refs"][2])
    _dispatch(programs, early, refs_next)
    hf = _dispatch(programs, fresh, refs_next)
    want_n = _eager(n)
    _check_result(chain.fetch_chain(hn), n, want_n)
    _check_result(chain.fetch_chain(hf), fresh,
                  _eager(fresh, (want_n[0], n["refs"][1], n["refs"][2])))


def test_each_cdef_list_pair_is_a_key():
    """Frames at two quantizers carry two CDEF candidate list pairs: two
    keys, each equal to run_stages with its own lists."""
    fa, fb = _frame(64, 64, 8, Q_FALLBACK), _frame(64, 64, 9, Q_OTHER)
    assert (fa["y_list"], fa["uv_list"]) != (fb["y_list"], fb["uv_list"])
    programs = ChainPrograms("cpu")
    for f in (fa, fb, fa):
        got = programs.run(f["geom"], f["src"], f["refs"], _aux(f),
                           f["y_list"], f["uv_list"])
        for a, b in zip(got[0], _eager(f)[0]):
            assert torch.equal(a, b)
    assert programs.stats()["keys"] == 2
    assert programs.stats()["eager"] == 3


def test_stages_are_capturable_after_the_first_frame():
    f = _frame(64, 64, 10, Q_OTHER)
    _eager(f)  # the eager frame: makes the stages' device constants
    src = tuple(torch.from_numpy(p) for p in f["src"])
    aux = torch.from_numpy(_aux(f))
    with HostReads() as mode:
        chain.run_stages(f["geom"], src, f["refs"], aux, f["y_list"],
                         f["uv_list"])
    assert mode.found == []


def test_device_constant_miss_inside_a_capture_raises(monkeypatch):
    """A device_cache miss cannot be served inside a capture; the guard
    fires before the constant is made."""
    made = []

    @constants.device_cache
    def const(v, device):
        made.append(v)
        return torch.tensor(v)

    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="inside a CUDA graph capture"):
        const(3, "cuda")
    assert made == []
    assert const(3, "cpu").item() == 3
