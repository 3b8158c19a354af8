"""rav1e_tpu_torch.device.graphs' store of runner sets on the CPU, the port
alone.

A ``FramePipeline`` checks a set of runners (chain, analysis, CDEF) out of
``graphs.STORE`` on its first device run and returns it when its stream
ends, so the replayed programs outlive the context, as the reference's
compiled programs outlive it.  On the CPU the runners run their calls
eagerly into the same static buffers a card replays into, so a stale
buffer left by one context shows in the next one's packets.  Each test
gives the pipelines a store of its own, and the expected bytes are
rav1e_tpu's stored packets (``tests/data/torch_reference_packets.json``)
at ``reference_cells.py``'s cells, so no reference runs here.  The card
holds the store in chip_smoke.py's reference, gop and bench phases."""

import gc
import json
import sys
from pathlib import Path

import numpy as np
import pytest
from torch_threads import one_torch_cpu_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import rav1e_tpu_torch as r  # noqa: E402
import reference_cells  # noqa: E402
from rav1e_tpu_torch import native  # noqa: E402
from rav1e_tpu_torch.device import analysis, graphs  # noqa: E402

STORE = ROOT / "tests" / "data" / "torch_reference_packets.json"
# 64x64 8-bit 4:2:0 cells of three configurations, all through the chain:
# they share the analysis's keys
SHARING = ("low latency s6", "speed 8", "speed 10")


@pytest.fixture(scope="module")
def packets():
    with open(STORE) as f:
        return json.load(f)["cells"]


def _store(monkeypatch):
    store = graphs.ProgramStore()
    monkeypatch.setattr(graphs, "STORE", store)
    return store


@pytest.fixture
def store(monkeypatch):
    return _store(monkeypatch)


def _encode(name, packets):
    """Cell ``name`` through the port on the CPU; its packets must be
    rav1e_tpu's.  Returns the context."""
    assert native.get_lib() is not None  # the chain replays natively
    pkts, ctx = reference_cells.encode(r, name, device="cpu")
    got = [reference_cells.packet_record(p) for p in pkts]
    err = reference_cells.first_difference(got, packets[name]["packets"])
    assert err is None, f"{name}: {err}"
    return ctx


def _start(name):
    """A context of cell ``name`` that has sent all its frames and taken
    its first packet, so its pipeline has run on the device: (context,
    that packet)."""
    ctx, frames = reference_cells.new_context(r, name, device="cpu")
    for f in frames:
        reference_cells.send(ctx, r, f)
    ctx.flush()
    return ctx, ctx.receive_packet()


def test_a_later_context_takes_the_set_of_an_earlier_one(store, packets):
    """Two contexts of one cell in turn: the second pipeline holds the
    first's runner objects, each counts its own runs beside the set's, and
    both give rav1e_tpu's packets."""
    name = SHARING[0]
    first = _encode(name, packets)
    second = _encode(name, packets)
    a, b = first.pipeline, second.pipeline
    assert b._programs is a._programs
    assert b._chain_programs is a._chain_programs
    assert b._analysis_programs is a._analysis_programs
    assert b._cdef_programs is a._cdef_programs
    assert store.stats("cpu")["sets"] == 1
    own, total = b.program_stats(), a._programs.stats()
    for runner in ("chain", "analysis", "CDEF"):
        assert own[runner]["eager"] > 0
        assert a.program_stats()[runner]["eager"] == own[runner]["eager"]
        assert total[runner]["eager"] == 2 * own[runner]["eager"]
        assert own[runner]["set"] == total[runner]
        assert own[runner]["captures"] == own[runner]["replays"] == 0


def test_configurations_sharing_keys_through_one_set(store, packets):
    """Three configurations whose encodes share the analysis's keys, in
    order and then in reverse through one set: every cell gives rav1e_tpu's
    packets, so no static buffer carries one context's values into the
    next one's result."""
    keys = []
    for name in SHARING:
        keys.append(_store_keys(name, packets))
    assert len(set.intersection(*keys)) > 0
    for name in SHARING + SHARING[::-1]:
        _encode(name, packets)
    assert store.stats("cpu")["sets"] == 1
    st = store.stats("cpu")["by_set"][0]["analysis"]
    assert st["keys"] == len(set.union(*keys))


def _store_keys(name, packets):
    """The analysis keys of cell ``name`` alone, through a store of its
    own."""
    with pytest.MonkeyPatch.context() as mp:
        _store(mp)
        ctx = _encode(name, packets)
        return set(ctx.pipeline._analysis_programs._keys)


def test_live_contexts_hold_different_sets(store, packets):
    """Two contexts encoding at once hold a set each, and each gives
    rav1e_tpu's packets."""
    (a, pa), (b, pb) = _start(SHARING[1]), _start(SHARING[1])
    assert a.pipeline._programs is not b.pipeline._programs
    assert store.stats("cpu") | {"by_set": None} == {
        "sets": 2, "in_use": 2, "by_set": None, "pool_bytes": 0}
    want = packets[SHARING[1]]["packets"]
    for ctx, first in ((a, pa), (b, pb)):
        got = [first] + reference_cells.drain(ctx, r)
        assert [reference_cells.packet_record(p) for p in got] == want
    assert store.stats("cpu")["in_use"] == 0
    # the set released last goes out first
    assert _start(SHARING[1])[0].pipeline._programs is b.pipeline._programs


def test_a_dropped_context_returns_its_set(store):
    ctx, _ = _start(SHARING[1])
    pset = ctx.pipeline._programs
    assert store.stats("cpu")["in_use"] == 1
    del ctx
    gc.collect()
    assert store.stats("cpu")["in_use"] == 0
    assert _start(SHARING[1])[0].pipeline._programs is pset


def test_a_set_whose_run_raised_is_dropped(store, monkeypatch):
    """A run that raises marks its runner; the set is not returned when its
    context goes, and the next context gets a new one."""
    def broken(d, bd, flags):
        raise RuntimeError("analysis broken on purpose")

    ctx, frames = reference_cells.new_context(r, SHARING[1], device="cpu")
    with monkeypatch.context() as mp:
        mp.setattr(analysis, "analysis_call", broken)
        with pytest.raises(RuntimeError, match="on purpose"):
            for f in frames:
                reference_cells.send(ctx, r, f)
            reference_cells.drain(ctx, r)
    pset = ctx.pipeline._programs
    assert pset.failed and pset.analysis.failed
    assert store.stats("cpu")["in_use"] == 1
    del ctx
    gc.collect()
    assert store.stats("cpu") == {"sets": 0, "in_use": 0, "by_set": [],
                                  "pool_bytes": 0}
    later = _start(SHARING[1])[0].pipeline._programs
    assert later is not pset and not later.failed


# the GOP channel: 6 chunks of 4 frames (each led by a key frame) of a
# 64x64 pan at the bench clip's settings, on 3 slots
CHUNK, CHUNKS, SLOTS = 4, 6, 3


def _gop_config(slots):
    cell = dict(reference_cells.CELLS["bench clip"], width=64, height=64)
    enc = reference_cells.encoder_config(r, cell)
    enc.min_key_frame_interval = enc.max_key_frame_interval = CHUNK
    return r.Config(enc=enc, device="cpu", parallel_gops=slots)


@pytest.fixture(scope="module")
def gop():
    """The 3-slot channel's packets, its template context, the store's
    stats after it, and each chunk's packets encoded alone."""
    clip = reference_cells.pan_runs(64, 64, [CHUNK * CHUNKS],
                                    np.random.default_rng(7))[0]
    with pytest.MonkeyPatch.context() as mp:
        store = _store(mp)
        sender, receiver = _gop_config(SLOTS).new_channel()
        for planes in clip:
            f = sender.new_frame()
            for p, arr in zip(f.planes, planes):
                p.copy_from(arr)
            sender.send(f)
        sender.close()
        pkts = list(receiver)
        stats = store.stats("cpu")
    alone = []
    for c in range(CHUNKS):
        ctx = _gop_config(0).new_context()
        for planes in clip[c * CHUNK : (c + 1) * CHUNK]:
            reference_cells.send(ctx, r, planes)
        chunk = reference_cells.drain(ctx, r)
        for p in chunk:
            p.input_frameno += c * CHUNK
        alone += chunk
    return {"pkts": pkts, "template": sender._ctx, "stats": stats,
            "alone": alone}


def test_gop_template_context_holds_no_set(gop):
    assert gop["template"].pipeline._programs is None
    assert gop["template"].pipeline.program_stats() == {}


def test_gop_slots_take_at_most_one_set_each(gop):
    """Six chunks on three slots: at most three sets, all returned, and the
    packets those of each chunk encoded alone."""
    st = gop["stats"]
    assert 1 <= st["sets"] <= SLOTS and st["in_use"] == 0
    assert [(p.data, p.input_frameno) for p in gop["pkts"]] == [
        (p.data, p.input_frameno) for p in gop["alone"]]
