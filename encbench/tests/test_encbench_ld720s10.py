"""The ld720s10.live cell: the readers of the chain's share of inter frames
and of the program's frame-in-flight spans, on made-up observations, and
one traced run of the cell on the CPU at a size whose bottom edge forces
16x16 leaves, as 720 rows do."""

import time

from encbench import harness
from encbench.harness import Observations


def obs(spans):
    """A 4 s window, [10, 14]."""
    o = Observations(t0=10.0, t1=14.0, window_s=4.0, frames=4)
    o.spans = spans
    return o


def read(name, o):
    return harness.reader(name)(o)


def test_chain_share_counts_the_windows_counters():
    o = obs([("inter_chain", 9.9, 9.9),      # before the window
             ("inter_chain", 10.5, 10.5), ("inter_chain", 11.5, 11.5),
             ("inter_host", 12.0, 12.0), ("inter_chain", 13.0, 13.0),
             ("ref_update", 12.9, 13.1)])
    assert read("chain_inter_share", o) == 75.0
    assert read("chain_inter_share", obs([("inter_host", 11.0, 11.0)])) == 0.0


def test_chain_share_none_without_counters_or_untraced():
    assert read("chain_inter_share", obs([("ref_update", 11.0, 11.1)])) is None
    assert read("chain_inter_share", Observations(t0=10.0, t1=14.0)) is None


def test_in_flight_p95_pairs_each_end_with_the_start_before_it():
    # twenty frames ending inside, of 10..29 ms, each start and end
    # recorded together (the ends in order of arrival); a frame shown
    # after the window, whose start alone lies in it; a collection
    # recorded between a start and its end
    marks = []
    for i in range(20):
        end = 11.0 + i * 0.1
        marks += [("frame_in_flight_start", end - (10 + i) / 1e3,
                   end - (10 + i) / 1e3),
                  ("frame_in_flight_end", end, end)]
    marks.insert(3, ("py_gc", 11.05, 11.06))
    marks += [("frame_in_flight_start", 13.99, 13.99)]
    got = read("frame_in_flight_p95_ms", obs(marks))
    assert abs(got - 28.0) < 1e-9
    assert read("frame_in_flight_p95_ms", obs([("plan", 11.0, 12.0)])) is None
    assert read("frame_in_flight_p95_ms",
                Observations(t0=10.0, t1=14.0)) is None


def test_a_traced_run_of_the_cell_reads_both():
    """160x80, speed 10, low latency: every inter frame on the chain, every
    packet decoded to its reconstruction, both metrics reported."""
    from encbench.tests.conftest import tiny_spec

    spec = tiny_spec("ld720s10.live", trace=True)
    spec.config["height"] = 80
    result, _ = harness.run_cell(spec, 2**31 + 11, 1.0, True,
                                 time.monotonic(), device="cpu", workers=1)
    assert result["correct"], result
    got = result["metrics"]
    assert got["chain_inter_share"]["value"] == 100.0
    assert got["frame_in_flight_p95_ms"]["value"] > 0
