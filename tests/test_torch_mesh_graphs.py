"""The analysis mesh through the band runners of rav1e_tpu_torch.device.graphs
on CPU slots, the port alone.

Under the analysis mesh each band of a frame runs through the runner its
pipeline's set holds for the band's slot (``BandPrograms``): on a card one
CUDA graph per key, on the CPU the same calls run eagerly into the same
static buffers, so these tests see what a replay would leave behind.  On
``make_mesh(n, devices=["cpu"] * n)``: the runners equal the eager
``analysis._mesh_frame_analysis`` and the unsharded ``_frame_analysis`` at
the four keys with q and lambda changing between frames, on 3 slots of a
192-row frame (the middle band has halo rows on both sides); a band's
packed outputs survive the slot's next run (the clone); after a key's
first run the band's body reads no device value on the host and makes no
tensor from host data; each runner of a set has a graph pool of its own; a
failed band run names its slot and key and marks the set; a 2-slot mesh
encode of reference_cells.py's ragged cell gives rav1e_tpu's stored
packets; and the slots' streams are made once whichever threads ask.  The
card runs the graphs in chip_smoke.py's mesh phase."""

import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from host_reads import HostReads
from torch_threads import one_torch_cpu_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import rav1e_tpu_torch as r  # noqa: E402
import reference_cells  # noqa: E402
from rav1e_tpu_torch import native, tables  # noqa: E402
from rav1e_tpu_torch.device import analysis, graphs  # noqa: E402
from rav1e_tpu_torch.parallel import make_mesh  # noqa: E402
from rav1e_tpu_torch.parallel.mesh import (  # noqa: E402
    Mesh,
    ShardedPlane,
    band_rows,
)

H, W, SLOTS = 192, 64, 3
ROWS = ((0, 64), (64, 128), (128, 192))
# (has_inter, has_bwd, has_bwd2) of the four keys of a pyramid clip
KEYS = {"intra": (False, False, False), "fwd": (True, False, False),
        "fwd+bwd": (True, True, False), "fwd+bwd+bwd2": (True, True, True)}
STORE = ROOT / "tests" / "data" / "torch_reference_packets.json"


def _planes(seed, n=4):
    """n seeded 8-bit luma planes of one texture moving down and right,
    (H, W) uint8, so that motion search reads across band edges."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (H // 4 + 8, W // 4 + 8))
    tex = np.repeat(np.repeat(coarse, 4, 0), 4, 1).astype(np.int32)
    return [np.clip(tex[3 * i : 3 * i + H, 2 * i : 2 * i + W]
                    + rng.integers(-5, 6, (H, W)), 0, 255).astype(np.uint8)
            for i in range(n)]


def _lam(qi):
    return 0.12 * (tables.ac_q(qi, 0, 8) / 8.0) ** 2


@pytest.fixture
def mesh(monkeypatch):
    """3 CPU slots, made the analysis mesh of every device."""
    m = make_mesh(SLOTS, devices=["cpu"] * SLOTS)
    monkeypatch.setattr(analysis, "_analysis_mesh", lambda device: m)
    return m


def _dispatch(programs, planes, flags, qi):
    refs = [p if used else None for p, used in zip(planes[1:], flags)]
    return analysis.analyze_frame_async(
        planes[0], refs[0], refs[1], qi, _lam(qi), 8, ref2_np=refs[2],
        device="cpu", programs=programs)


def _used(planes, flags):
    """The planes a key reads, the others standing in as the whole-frame
    run has them."""
    t = list(planes)
    ref0 = t[1] if flags[0] else t[0]
    ref1 = t[2] if flags[1] else ref0
    ref2 = t[3] if flags[2] else ref0
    return t[0], ref0, ref1, ref2


def _eager_mesh(mesh, planes, flags, qi):
    sharded = [ShardedPlane.put(mesh, ROWS, p) for p in planes]
    return analysis._mesh_frame_analysis(mesh, ROWS, _used(sharded, flags),
                                         qi, _lam(qi), 8, flags)


def _unsharded(planes, flags, qi):
    t = [torch.from_numpy(p).to(torch.int32) for p in planes]
    q, lam = analysis._scalars(qi, _lam(qi), 8, "cpu")
    return analysis._frame_analysis(*_used(t, flags), q, lam, 8, *flags)[:7]


def _assert_equal(got, want):
    assert len(got) == len(want) == 7
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("key", list(KEYS))
def test_band_runners_equal_eager_mesh_and_unsharded(key, mesh):
    """Two frames of one key at two quantizers through the set's band
    runners: each equals the eager mesh analysis and the unsharded one
    exactly, bits_est included, and each slot's runner ran the key twice."""
    assert band_rows(H, SLOTS) == ROWS
    flags = KEYS[key]
    programs = graphs.AnalysisPrograms("cpu")
    for seed, qi in ((1, 100), (2, 160)):
        planes = _planes(seed)
        handle = _dispatch(programs, planes, flags, qi)
        assert handle[1:] == flags
        _assert_equal(handle[0], _eager_mesh(mesh, planes, flags, qi))
        _assert_equal(handle[0], _unsharded(planes, flags, qi))
    assert programs.stats()["keys"] == 0  # every frame split
    for i, (lo, hi) in enumerate(ROWS):
        st = programs.band(mesh, i).stats()
        top = min(128, lo)
        assert st["by_key"] == [((H, W), top, hi - lo, 8, *flags, 2, 0)]
        assert programs.holder_counts[f"band {i}"] == {
            "eager": 2, "captures": 0, "replays": 0}


def test_band_outputs_outlive_the_slots_next_run(mesh):
    """Two analyses of one key dispatched before either is read each finish
    to their own maps; and a band's packed outputs, as its runner hands
    them to the gather, are unchanged by the slot's next run (the copy made
    right after the run: the runner's own output buffer is overwritten)."""
    flags = KEYS["fwd+bwd"]
    programs = graphs.AnalysisPrograms("cpu")
    frames = [(_planes(3), 90), (_planes(4), 150)]
    handles = [_dispatch(programs, p, flags, qi) for p, qi in frames]
    for handle, (planes, qi) in zip(handles, frames):
        got = analysis.analyze_finish(handle)
        want = analysis.analyze_finish((_unsharded(planes, flags, qi),
                                        *flags))
        for field in ("size_log2", "mode", "use_inter", "mv0", "mv1"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field))
        assert got.bits_est == want.bits_est and got.mv2 is None

    runner = programs.band(mesh, 1)
    outs = [runner.run(*[torch.from_numpy(p) for p in planes[:3]], None, 64,
                       64, float(tables.ac_q(qi, 0, 8)), _lam(qi), 8, flags)
            for planes, qi in frames[:1]]
    kept = outs[0].clone()
    planes, qi = frames[1]
    outs.append(runner.run(*[torch.from_numpy(p) for p in planes[:3]], None,
                           64, 64, float(tables.ac_q(qi, 0, 8)), _lam(qi), 8,
                           flags))
    assert torch.equal(outs[0], kept)
    assert not torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("key", ["intra", "fwd+bwd+bwd2"])
def test_band_is_capturable_after_the_first_run(key, mesh):
    """The middle band (halo rows on both sides) after its key's eager
    run; the bands differ only in the rows they keep."""
    flags = KEYS[key]
    programs = graphs.AnalysisPrograms("cpu")
    _dispatch(programs, _planes(7), flags, 120)  # every band's eager run
    d = programs.band(mesh, 1)._keys[((H, W), 64, 64, 8, *flags)].data
    with HostReads() as mode:
        analysis.band_call(d, 64, 64, 8, flags)
    assert mode.found == []


def test_every_runner_of_a_set_has_a_pool_of_its_own(mesh, monkeypatch):
    """The slots of a mesh replay at once on their streams: no band runner
    shares a graph pool with another runner of its set."""
    made = []

    def handle():
        made.append(object())
        return made[-1]

    monkeypatch.setattr(torch.cuda, "graph_pool_handle", handle)
    pset = graphs.ProgramSet("cpu")
    _dispatch(pset.analysis, _planes(8), KEYS["fwd"], 120)
    runners = pset.runners()
    assert list(runners) == ["chain", "analysis", "CDEF", "band 0",
                             "band 1", "band 2"]
    pools = [rn.graph_pool() for rn in runners.values()]
    assert len({id(p) for p in pools}) == len(pools) == len(made)
    assert [rn.graph_pool() for rn in runners.values()] == pools


def test_a_failed_band_names_its_slot_and_key(mesh, monkeypatch):
    def broken(d, top, rows, bd, flags):
        if top == 64:
            raise RuntimeError("band broken on purpose")
        return real(d, top, rows, bd, flags)

    real = analysis.band_call
    monkeypatch.setattr(analysis, "band_call", broken)
    pset = graphs.ProgramSet("cpu")
    with pytest.raises(RuntimeError, match="on purpose") as e:
        _dispatch(pset.analysis, _planes(9), KEYS["intra"], 120)
    assert ("in a run of the band 1 analysis of key ((192, 64), 64, 64, 8, "
            "False, False, False)") in e.value.__notes__
    assert pset.failed and pset.analysis.band(mesh, 1).failed
    assert not pset.analysis.band(mesh, 0).failed


def test_mesh_encode_gives_reference_packets_through_one_set(monkeypatch):
    """reference_cells.py's ragged 100x76 cell (128 padded rows: two
    superblock rows, a band each on 2 CPU slots) through one set's band
    runners gives rav1e_tpu's stored packets; the pipeline reports each
    slot's runner beside the whole-frame runner."""
    assert native.get_lib() is not None  # the chain replays natively
    mesh = make_mesh(2, devices=["cpu"] * 2)
    monkeypatch.setattr(analysis, "_analysis_mesh", lambda device: mesh)
    monkeypatch.setattr(graphs, "STORE", graphs.ProgramStore())
    name = "ragged 200x136 s6"
    with open(STORE) as f:
        want = json.load(f)["cells"][name]["packets"]
    pkts, ctx = reference_cells.encode(r, name, device="cpu")
    got = [reference_cells.packet_record(p) for p in pkts]
    assert reference_cells.first_difference(got, want) is None
    assert len(got) == len(want)
    p = ctx.pipeline
    assert any(isinstance(v, ShardedPlane)
               for v in p._dev_luma_cache.values())
    stats = p.program_stats()
    assert list(stats) == ["chain", "analysis", "CDEF", "band 0", "band 1"]
    assert stats["analysis"]["eager"] == 0
    for slot in ("band 0", "band 1"):
        st = stats[slot]
        assert st["eager"] >= 2 and st["captures"] == st["replays"] == 0
        assert st["set"]["eager"] == st["eager"]
        assert st["set"]["keys"] == 2  # intra and forward
    assert set(p._programs.analysis.bands) == {(mesh, 0), (mesh, 1)}


def test_slot_streams_are_made_once(monkeypatch):
    """Eight threads asking a mesh of card slots for its streams at once,
    with stream creation slowed down, all get the one tuple."""
    made = []

    class SlowStream:
        def __init__(self, device=None):
            time.sleep(0.02)
            made.append(self)

    monkeypatch.setattr(torch.cuda, "Stream", SlowStream)
    mesh = Mesh(["cuda:0"] * 4)
    start = threading.Barrier(8)
    got = [None] * 8

    def ask(i):
        start.wait()
        got[i] = mesh.streams()

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(g is got[0] for g in got)
    assert len(made) == 4 and list(got[0]) == made
