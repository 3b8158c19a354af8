"""rav1e_tpu_torch's trace (``utils/trace.py``): the spans a tiny
random-access and low-latency encode opens, the chrome format every event
keeps, the ``plan`` span closing on the scheduler's exceptions, collection
off, Python's garbage collections as ``py_gc`` spans, and the bridge into a
``torch.profiler`` session on the monotonic clock (on the CPU here; on the
card, a span brackets its kernel's device record: ``python -m pytest
tests/test_torch_trace.py --noconftest -m card``, without the JAX that
tests/conftest.py imports)."""

import gc
import json
import time

import numpy as np
import pytest
import torch

import native_libs
import rav1e_tpu_torch as r
from rav1e_tpu_torch.api.context import ContextInner
from rav1e_tpu_torch.utils import trace
from torch_threads import one_torch_cpu_thread  # noqa: F401

W, H = 128, 64
PROFILER_MARK = "test.profiler_mark"

# the spans each path reaches at this size: the API and scheduler, the
# frame's set-up, the chain's planning, predispatch and decisions, packet
# assembly and the reference update, the key frame's host coder (second
# pass, LRF copy and filter, the CDEF stage's download), and the host's
# waits on the device.  Random access adds the lookahead and the analyses
# launched ahead; in low latency, a frame sent and drained at a time, no
# later frame is queued while one is coded, so none is launched ahead.
COMMON = {"new_frame", "frame_intake", "scene_detect", "plan", "frame_setup",
          "chain_plan", "chain_predispatch", "chain_decisions",
          "packet_assembly", "ref_update", "encode_tiles_p2",
          "deblocked_copy", "lrf_filter", "ref_upload", "analysis_download",
          "luma_upload_wait", "cdef_download", "recon_download",
          "chain_wait_ready", "chain_download_levels"}
REACHED = {"random access": COMMON | {"lookahead", "analysis_predispatch"},
           "low latency": COMMON}


def _config(low_latency):
    return r.Config(enc=r.EncoderConfig(
        width=W, height=H, quantizer=100, low_latency=low_latency,
        speed_settings=r.SpeedSettings.from_preset(6),
        min_key_frame_interval=0, max_key_frame_interval=999),
        device="cpu")


def _encode(low_latency, nframes=6):
    """A panning texture; every packet's reconstruction read back."""
    ctx = _config(low_latency).new_context()
    rng = np.random.default_rng(15)
    coarse = rng.integers(0, 256, (H // 8 + 2, W // 8 + 2))
    base = np.repeat(np.repeat(coarse, 8, 0), 8, 1)[:H, :W]
    pkts = []
    for t in range(nframes + 1):
        if t < nframes:
            f = ctx.new_frame()
            for i, p in enumerate(f.planes):
                ch, cw = p.cfg.height, p.cfg.width
                arr = (np.roll(base, 2 * t, axis=1) if i == 0
                       else np.full((ch, cw), 128))
                arr = arr + rng.integers(-2, 3, (ch, cw))
                p.copy_from(np.clip(arr, 0, 255).astype(np.uint8))
            ctx.send_frame(f)
        else:
            ctx.flush()
        while True:
            try:
                pkts.append(ctx.receive_packet())
            except (r.EncoderStatus.NeedMoreData,
                    r.EncoderStatus.LimitReached):
                break
    for p in pkts:
        if p.rec is not None:
            p.rec.planes  # a chain frame's reconstruction comes down here
    return pkts


@pytest.fixture(scope="module", params=sorted(REACHED))
def encoded(request, tmp_path_factory):
    """(path, the events of a traced encode as ``trace_write`` wrote them,
    the packets)."""
    # here and not at import: the card's test runs without the reference
    native_libs.build()
    native_libs.require()
    trace.trace_enable()
    trace.reset()
    try:
        pkts = _encode(request.param == "low latency")
        out = trace.trace_write(str(tmp_path_factory.mktemp("trace")
                                    / "trace.json"))
    finally:
        trace.trace_disable()
        trace.reset()
    with open(out) as f:
        return request.param, json.load(f)["traceEvents"], pkts


def test_an_encode_opens_every_span_of_its_path(encoded):
    path, events, pkts = encoded
    names = {e["name"] for e in events}
    assert REACHED[path] <= names, sorted(REACHED[path] - names)
    assert ("lookahead" in names) == (path == "random access")
    assert ("analysis_predispatch" in names) == (path == "random access")
    # one intake, one set-up and one reference update a coded frame
    counts = {n: sum(e["name"] == n for e in events)
              for n in ("frame_intake", "frame_setup", "ref_update")}
    coded = sum(1 for p in pkts if p.rec is not None and p.qp > 0)
    assert counts["frame_intake"] == 6
    assert counts["frame_setup"] == counts["ref_update"] == coded


def test_every_event_is_a_complete_event(encoded):
    _path, events, _pkts = encoded
    assert events
    for e in events:
        assert e["ph"] == "X" and e["dur"] >= 0, e
        assert {"name", "ts", "dur", "pid", "tid", "args"} <= set(e), e


def test_frame_in_flight_and_the_inter_counters(encoded):
    """A shown frame's time in flight as two zero-length marks recorded one
    right after the other, from before its intake to after it; one
    inter_chain counter a coded inter frame, all of them the chain's at
    this size."""
    _path, events, pkts = encoded

    def by_frame(name):
        return {e["args"]["frame"]: e for e in events if e["name"] == name}

    start, end = (by_frame("frame_in_flight_start"),
                  by_frame("frame_in_flight_end"))
    intake = by_frame("frame_intake")
    shown = sorted(p.input_frameno for p in pkts if p.show_frame)
    assert sorted(start) == sorted(end) == shown
    for f in shown:
        assert start[f]["dur"] == end[f]["dur"] == 0
        assert start[f]["ts"] <= intake[f]["ts"]
        assert end[f]["ts"] >= intake[f]["ts"] + intake[f]["dur"]
        assert events.index(end[f]) - events.index(start[f]) == 1
    inter = {p.input_frameno for p in pkts
             if p.frame_type == r.FrameType.INTER}
    assert sorted(by_frame("inter_chain")) == sorted(inter)
    assert not by_frame("inter_host")


def test_spans_nest_inside_the_frame_that_opened_them(encoded):
    """scene_detect inside frame_intake, lookahead inside plan."""
    _path, events, _pkts = encoded

    def inside(inner, outer):
        outs = [(e["ts"], e["ts"] + e["dur"]) for e in events
                if e["name"] == outer]
        for e in events:
            if e["name"] == inner:
                assert any(a <= e["ts"] and e["ts"] + e["dur"] <= b + 1e-3
                           for a, b in outs), (inner, outer, e)

    inside("scene_detect", "frame_intake")
    inside("lookahead", "plan")


@pytest.mark.parametrize("status, limit", [("NeedMoreData", None),
                                           ("LimitReached", 0)])
def test_the_plan_span_closes_when_the_scheduler_raises(monkeypatch, status,
                                                        limit):
    monkeypatch.setattr(trace, "_enabled", True)
    trace.reset()
    inner = ContextInner(_config(False))
    inner.limit = limit
    try:
        with pytest.raises(getattr(r.EncoderStatus, status)):
            inner._extend_plan(False)
        names = [e["name"] for e in trace._events]
    finally:
        trace.reset()
    assert names == ["plan"]


def test_off_records_nothing_and_leaves_no_gc_callback():
    trace.trace_enable()
    trace.trace_disable()
    assert trace._on_gc not in gc.callbacks
    assert not trace.trace_enabled()
    trace.reset()
    # off, every span is the one shared no-op context
    assert trace.span("a") is trace.span("b", frame=1)
    with trace.span("a"):
        gc.collect()
    assert trace._events == []


def test_a_collection_is_a_py_gc_span():
    trace.trace_enable()
    trace.reset()
    try:
        t0 = time.monotonic()
        gc.collect()
        t1 = time.monotonic()
        evs = [e for e in trace._events if e["name"] == "py_gc"]
    finally:
        trace.trace_disable()
        trace.reset()
    full = [e for e in evs if e["args"]["generation"] == 2]
    assert full and full[0]["args"]["collected"] >= 0
    start = trace._t0 + full[0]["ts"] / 1e6
    assert t0 <= start <= t1


def test_a_collection_while_off_through_the_callback_records_nothing(
        monkeypatch):
    """Tests switch the flag directly: the installed callback tests it."""
    trace.trace_enable()
    monkeypatch.setattr(trace, "_enabled", False)
    trace.reset()
    try:
        gc.collect()
        assert trace._events == []
    finally:
        trace.trace_disable()


def test_covered_time_is_the_union_of_the_spans_inside_an_interval():
    trace.reset()
    t = trace._t0
    try:
        for name, a, b in (("a", 1.0, 2.0), ("b", 1.5, 3.0), ("c", 5.0, 6.0),
                           ("d", 0.0, 0.2)):
            trace._record(name, t + a, t + b, {})
        assert trace.covered_s(t + 0.5, t + 4.0) == pytest.approx(2.0)
        assert trace.covered_s(t + 3.5, t + 4.5) == 0.0
    finally:
        trace.reset()


def test_the_cli_benchmark_summary(tmp_path, capsys):
    """``--benchmark``: the spans by total time, most first, then the
    encode's time in no span (at 64x48, where no device stage runs)."""
    from rav1e_tpu_torch import cli

    w, h, n = 64, 48, 3
    rng = np.random.default_rng(3)
    clip = tmp_path / "in.y4m"
    with open(clip, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F30:1 Ip A1:1 C420jpeg\n".encode())
        for _ in range(n):
            f.write(b"FRAME\n")
            f.write(rng.integers(0, 256, w * h + 2 * (w // 2) * (h // 2),
                                 dtype=np.uint8).tobytes())
    try:
        assert cli.main([str(clip), "-o", str(tmp_path / "out.ivf"),
                         "--device", "cpu", "--benchmark"]) == 0
    finally:
        trace.trace_disable()
        trace.reset()
    err = capsys.readouterr().err.splitlines()
    totals = [float(line.split(": ")[1].split(" ms")[0]) for line in err
              if " ms total, " in line]
    assert len(totals) > 3 and totals == sorted(totals, reverse=True)
    bare = [line for line in err if line.startswith("  in no span: ")]
    assert len(bare) == 1
    ms, of = bare[0].split(": ")[1].split(" ms of the encode's ")
    assert 0.0 <= float(ms) <= float(of)


def _profiled(activities, body):
    """Run ``body`` in a profiler session; returns the session's records
    and the offset from the profiler's clock to the monotonic one, from a
    mark as encbench/devtrace.py takes it."""
    from torch.profiler import profile, record_function

    with record_function("warm up"):
        pass
    prof = profile(activities=activities)
    prof.__enter__()
    mark_ns = time.monotonic_ns()
    with record_function(PROFILER_MARK):
        pass
    try:
        body()
    finally:
        prof.__exit__(None, None, None)
    evs = list(prof.profiler.kineto_results.events())
    mark = [e for e in evs if e.name() == PROFILER_MARK][0]
    return evs, mark.start_ns() - mark_ns


def test_a_span_is_a_profiler_range_on_the_monotonic_clock():
    from torch.profiler import ProfilerActivity

    trace.trace_enable()
    trace.reset()
    starts = []

    def body():
        starts.append(time.monotonic_ns())
        with trace.span("frame_setup"):
            time.sleep(0.003)

    try:
        evs, off = _profiled([ProfilerActivity.CPU], body)
        ours = [e for e in trace._events if e["name"] == "frame_setup"]
    finally:
        trace.trace_disable()
        trace.reset()
    rec = [e for e in evs if e.name() == "frame_setup"]
    assert len(rec) == 1 and len(ours) == 1
    span_start = trace._t0 + ours[0]["ts"] / 1e6
    assert abs((rec[0].start_ns() - off) / 1e9 - span_start) < 1e-3
    assert rec[0].duration_ns() / 1e3 == pytest.approx(ours[0]["dur"],
                                                       abs=1e3)
    # outside a session a span opens no range
    assert trace._profiler_range("frame_setup") is None


@pytest.mark.card
def test_a_span_brackets_its_kernel_on_the_card():
    """A span around a kernel and its synchronize holds the kernel's device
    record, mapped to the monotonic clock; the span itself adds no record to
    the device's timeline."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    from torch.profiler import ProfilerActivity

    x = torch.randn(1024, 1024, device="cuda")
    torch.cuda.synchronize()
    trace.trace_enable()
    trace.reset()

    def body():
        with trace.span("chain_dispatch"):
            (x @ x).sum()
            torch.cuda.synchronize()

    try:
        evs, off = _profiled([ProfilerActivity.CPU, ProfilerActivity.CUDA],
                             body)
        ours = [e for e in trace._events if e["name"] == "chain_dispatch"]
    finally:
        trace.trace_disable()
        trace.reset()
    cuda = torch.autograd.DeviceType.CUDA
    dev = [e for e in evs if e.device_type() == cuda]
    assert dev and not [e for e in dev if e.name() == "chain_dispatch"]
    a = trace._t0 + ours[0]["ts"] / 1e6
    b = a + ours[0]["dur"] / 1e6
    for e in dev:
        s = (e.start_ns() - off) / 1e9
        assert a - 1e-3 <= s and s + e.duration_ns() / 1e9 <= b + 1e-3, \
            (e.name(), s, a, b)
