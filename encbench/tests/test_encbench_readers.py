"""The per-layer readers and the trace arithmetic on made-up observations."""

import pytest

from encbench import devtrace, harness
from encbench.harness import Observations


def obs():
    o = Observations(t0=10.0, t1=14.0, window_s=4.0, frames=4,
                     fixed_frames=2, fixed_bytes=3000, fixed_psnr_y_db=40.0,
                     setup_s=20.0, latencies_s=[0.1, 0.2, 0.3, 0.4])
    o.spans = [("encode_tiles", 9.5, 10.5), ("chain_dispatch", 11.0, 11.2),
               ("chain_replay_code", 11.1, 11.5), ("device_analysis",
                                                   12.0, 12.1),
               ("lrf_decide", 13.0, 13.1)]
    o.api_calls = [("send_frame", 10.0, 10.1), ("receive_packet", 10.1, 14.0)]
    o.program_runs = {"chain": {"eager": 0, "captures": 1, "replays": 9},
                      "analysis": {"eager": 2, "captures": 0, "replays": 5}}
    o.device_events = [("grid_search_kernel", 10.2, 10.3),
                       ("grid_search_kernel", 12.0, 12.1),
                       ("other", 12.05, 12.5), ("other", 20.0, 21.0)]
    o.kernel_bound_s = {"grid_search": 0.02}
    return o


@pytest.mark.parametrize("name, want", [
    ("encode_fps", 1.0),
    ("frame_latency_p95_ms.live", 400.0),
    ("bytes_per_frame", 1500.0),
    ("psnr_y_db", 40.0),
    ("setup_s", 20.0),
    # 4 s less the union of the spans inside [10, 14]: 0.5 + 0.5 + 0.1 + 0.1
    ("pipeline_unspanned_ms", (4.0 - 1.2) / 4 * 1e3),
    ("chain_dispatch_ms", 200.0),
    # (0.5 of encode_tiles in the window + 0.4 + 0.1) / 4 frames
    ("host_coder_ms", 250.0),
    ("device_analysis_ms", 25.0),
    ("graph_runs_unreplayed", 3),
    ("grid_search_roofline", 20.0),
    # busy 0.1 + 0.5 of 4 s
    ("device_idle_share", 85.0),
])
def test_reader(name, want):
    assert harness.reader(name)(obs()) == pytest.approx(want)


def test_readers_with_nothing_to_read_return_none():
    o = Observations(window_s=1.0, frames=1)
    for name in ("pipeline_unspanned_ms", "chain_dispatch_ms",
                 "host_coder_ms", "device_analysis_ms",
                 "graph_runs_unreplayed", "grid_search_roofline",
                 "device_idle_share", "frame_latency_p95_ms.live"):
        assert harness.reader(name)(o) is None, name


def test_idle_gaps_and_what_the_host_did():
    o = obs()
    gaps = devtrace.idle_gaps(o.device_events, o.t0, o.t1)
    assert gaps[0] == pytest.approx((10.3, 12.0))
    assert devtrace.host_activity(o.spans, o.api_calls, 11.4) == \
        "receive_packet / chain_replay_code"
    assert devtrace.host_activity(o.spans, o.api_calls, 13.5) == \
        "receive_packet / no program span"
    assert devtrace.host_activity([], [], 1.0) == \
        "between API calls / no program span"


def test_program_spans_on_the_monotonic_clock():
    """The program's spans, read through its trace's public writer, line up
    with time.monotonic to well within a millisecond; the clock mark is
    left out."""
    import time

    from rav1e_tpu_torch.utils import trace as trace_mod

    trace_mod.trace_enable()
    trace_mod.reset()
    try:
        mark = harness.clock_mark(trace_mod)
        t0 = time.monotonic()
        with trace_mod.span("encode_tiles"):
            time.sleep(0.02)
        t1 = time.monotonic()
        spans = harness.span_list(trace_mod, mark)
    finally:
        trace_mod.reset()
    assert [s[0] for s in spans] == ["encode_tiles"]
    assert spans[0][1] == pytest.approx(t0, abs=5e-4)
    assert spans[0][2] == pytest.approx(t1, abs=5e-4)


def test_a_traced_run_reads_the_programs_spans():
    """A traced run on the CPU at a tiny size: the span and counter
    metrics come out, the device's (no card) are left out."""
    from encbench.tests.conftest import tiny_run

    result, _ = tiny_run("ld720.live", seconds=1.0, trace=True)
    assert result["correct"], result
    got = result["metrics"]
    for name in ("pipeline_unspanned_ms", "host_coder_ms",
                 "device_analysis_ms", "graph_runs_unreplayed",
                 "frame_latency_p95_ms.live"):
        assert name in got and got[name]["value"] >= 0, name
    assert "device_idle_share" not in got and "breakdown" not in result
