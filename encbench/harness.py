"""One run of one cell: set-up, the measured window, the check, the result.

Everything that belongs to a configuration, a traffic mix or a metric is a
file found by its name in ``BENCHMARK.json``:

- ``configs/<config>.json`` (via the configuration's ``file``): the
  encoder's settings;
- ``traffic/<traffic>.json``: the content (``content.py``'s parameters) and
  the warm-up clip;
- ``metrics/<metric>.py``: a ``read(obs)`` that returns the metric's value
  from the run's observations (:class:`Observations`), or None when there is
  nothing to read.

The program is ``rav1e_tpu_torch``; it is driven through its public API
(``Config(...).new_context()``, ``send_frame``, ``receive_packet``) and read
through its spans (``utils.trace``'s ``trace_write``), its programs' counters
(``FramePipeline.program_stats``) and its kernels' names.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from encbench import check as checkmod
from encbench.content import Clip

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
# modules the process that prints the result may not hold (by top-level name)
FORBIDDEN = ("jax", "jaxlib", "flax", "rav1e_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclass
class Spec:
    workload: dict
    config: dict
    traffic: dict
    metrics: list  # the metric entries this run reports


def load_spec(workload: str, trace: bool, root: Path = ROOT) -> Spec:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the cells are "
                         f"{sorted(cells)}")
    cell = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads(
        (PKG / "traffic" / f"{cell['traffic']}.json").read_text())
    group = bench["per_layer" if trace else "end_to_end"]
    metrics = [m for m in group
               if "workloads" not in m or workload in m["workloads"]]
    return Spec(cell, config, traffic, metrics)


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"encbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def encoder_config(r, c: dict):
    """The configuration file's settings as the port's EncoderConfig."""
    return r.EncoderConfig(
        width=c["width"], height=c["height"], bit_depth=c["bit_depth"],
        chroma_sampling=r.ChromaSampling[c["chroma_sampling"]],
        quantizer=c["quantizer"],
        min_key_frame_interval=c["min_key_frame_interval"],
        max_key_frame_interval=c["max_key_frame_interval"],
        low_latency=c["low_latency"], error_resilient=c["error_resilient"],
        tile_cols=c.get("tile_cols", 0), tile_rows=c.get("tile_rows", 0),
        speed_settings=r.SpeedSettings.from_preset(c["speed"]))


@dataclass
class Observations:
    """What a run observed; the metric readers take it."""

    setup_s: float = 0.0
    window_s: float = 0.0
    t0: float = 0.0
    t1: float = 0.0
    frames: int = 0                 # shown frames received in the window
    latencies_s: list = field(default_factory=list)  # per window frame
    fixed_frames: int = 0
    fixed_bytes: int = 0            # bytes of the packets of those frames
    fixed_psnr_y_db: float = None
    spans: list = None              # program spans (name, start, end), trace
    api_calls: list = None          # send_frame/receive_packet intervals
    program_runs: dict = None       # per runner: eager/captures/replays
    device_events: list = None      # (name, start, end) on the device
    kernel_bound_s: dict = None     # kernel -> least seconds per launch


def _send(ctx, planes):
    f = ctx.new_frame()
    for p, a in zip(f.planes, planes):
        p.copy_from(a)
    ctx.send_frame(f)


def drain(ctx, r, sink, calls=None):
    """receive_packet until the encoder needs more input; each packet goes
    to ``sink(packet, time)``; each call's (name, start, end) to ``calls``
    when given."""
    while True:
        t = time.monotonic()
        try:
            p = ctx.receive_packet()
        except r.EncoderStatus.NeedMoreData:
            if calls is not None:
                calls.append(("receive_packet", t, time.monotonic()))
            return
        now = time.monotonic()
        if calls is not None:
            calls.append(("receive_packet", t, now))
        sink(p, now)


def warm_up(r, make_config, traffic, seed, width, height, device):
    """Encode the traffic's warm-up clip (its own scenes, drawn from the
    seed) to its end in a context of its own: every key the cell's stream
    meets is run eagerly once and captured once, and the set of replayed
    programs goes back to the store for the measured context."""
    w = traffic["warmup"]
    content = dict(traffic["content"], scene_frames=w["scene_frames"])
    clip = Clip(content, width, height, seed ^ 0x5EED, device)
    ctx = make_config().new_context()
    n = 0
    for i in range(w["scene_frames"] * w["scenes"]):
        _send(ctx, clip.frame(i))
        drain(ctx, r, lambda p, t: None)
        n += 1
    ctx.flush()
    while True:
        try:
            ctx.receive_packet()
        except r.EncoderStatus.LimitReached:
            break
    return n


class Stream:
    """The measured stream: frames sent in order as fast as the encoder takes
    them (a closed loop), packets drained after each send, the window closed at the
    first packet received ``seconds`` after its start once no hidden frame is
    left unshown (or, should one never be shown, ``GRACE_S`` later), and the
    stream continued outside the window until the first ``fixed`` frames are
    all shown (for at most ``GRACE_S``)."""

    GRACE_S = 60.0

    def __init__(self, r, ctx, clip, seconds, fixed, calls=None):
        self.r, self.ctx, self.clip = r, ctx, clip
        self.calls = calls     # the API calls' intervals, when traced
        self.seconds, self.fixed = seconds, fixed
        self.packets = []      # (packet, receive time)
        self.sent_at = {}      # input frame -> send time
        self.shown = []        # input frames of shown packets, in order
        self.hidden = []       # input frames of hidden packets
        self.t0 = self.t1 = None
        self.window_frames = 0

    def _sink(self, p, t):
        self.packets.append((p, t))
        (self.shown if p.show_frame else self.hidden).append(p.input_frameno)

    def pending(self) -> bool:
        return bool(set(self.hidden) - set(self.shown))

    def run(self, on_start=None):
        r, ctx = self.r, self.ctx
        if on_start:
            on_start()
        self.t0 = time.monotonic()
        i = 0
        while True:
            t = self.sent_at[i] = time.monotonic()
            _send(ctx, self.clip.frame(i))
            if self.calls is not None:
                self.calls.append(("send_frame", t, time.monotonic()))
            i += 1
            drain(ctx, r, self._sink, self.calls)
            last = self.packets[-1][1] if self.packets else self.t0
            pending = self.pending()
            if self.t1 is None and last - self.t0 >= self.seconds and (
                    not pending or last - self.t0 >= self.seconds
                    + self.GRACE_S):
                self.t1 = last
                self.window_frames = len(self.shown)
            if self.t1 is not None and (
                    (len(self.shown) >= self.fixed and not pending)
                    or time.monotonic() - self.t1 >= self.GRACE_S):
                return i


def psnr(a, b, bd: int = 8) -> float:
    """utils/metrics.py's PSNR: 10 log10(peak^2 / MSE)."""
    mx = (1 << bd) - 1
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    if mse <= 0:
        return float("inf")
    return 10.0 * np.log10(mx * mx / mse)


def fixed_set(stream, fixed: int, width: int, height: int):
    """(bytes, luma PSNR) of the first ``fixed`` input frames: the bytes of
    every packet that codes one of them (hidden and shown), and the PSNR of
    the luma of their shown pictures against the source, over all their
    samples together."""
    nbytes = sum(len(p.data) for p, _t in stream.packets
                 if p.input_frameno < fixed)
    rec = {}
    for p, _t in stream.packets:
        if p.show_frame and p.input_frameno < fixed:
            rec[p.input_frameno] = p.rec.planes[0].as_array()[:height, :width]
    if not rec:
        return nbytes, None
    src = np.stack([stream.clip.frame(i)[0] for i in sorted(rec)])
    got = np.stack([rec[i] for i in sorted(rec)])
    return nbytes, float(psnr(got, src))


def grid_search_rounds(clip, device):
    """The least seconds per grid_search launch of this cell, averaged over
    the rounds the program's motion search runs on two frames of the cell's
    content (every motion search runs the same rounds at one frame size):
    the rounds' shapes recorded from the program's kernel wrapper."""
    import torch

    from rav1e_tpu_torch.device import kernels, me

    from encbench import bounds

    calls = []
    real = kernels.grid_search

    def record(src, ref_pad, by, bx, seeds, blk, R, step, pad_off, clip_mv):
        calls.append((int(src.shape[0]), len(list(seeds)), int(R), int(blk)))
        return real(src, ref_pad, by, bx, seeds, blk, R, step, pad_off,
                    clip_mv)

    a = torch.as_tensor(clip.frame(1)[0].astype(np.int32), device=device)
    b = torch.as_tensor(clip.frame(0)[0].astype(np.int32), device=device)
    kernels.grid_search = record
    try:
        me.me_field(a, b, 8)
    finally:
        kernels.grid_search = real
    torch.cuda.synchronize()
    rate = bounds.int32_ops_per_s()[0]
    per = [bounds.bound_s(*bounds.grid_search_work(*c), rate) for c in calls]
    return sum(per) / len(per), calls


SPAN_MARK = "encbench.clock_mark"


def clock_mark(trace_mod):
    """Open and close a span of our own; returns its start on the monotonic
    clock, which :func:`span_list` lines up with the span's own time."""
    t = time.monotonic()
    with trace_mod.span(SPAN_MARK):
        pass
    return t


def span_list(trace_mod, mark_s):
    """The program's spans as (name, start, end) on the monotonic clock,
    read through ``trace_write`` (the trace's chrome JSON, written to a
    temporary file and removed); ``mark_s`` is :func:`clock_mark`'s time."""
    import os
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        trace_mod.trace_write(path)
        with open(path) as f:
            evs = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    mark = [e for e in evs if e["name"] == SPAN_MARK]
    t0 = mark_s - mark[0]["ts"] / 1e6
    return [(e["name"], t0 + e["ts"] / 1e6, t0 + (e["ts"] + e["dur"]) / 1e6)
            for e in evs if e["name"] != SPAN_MARK]


def program_runs(ctx):
    """Per runner, the pipeline's own eager, capturing and replayed runs."""
    return {name: {k: st[k] for k in ("eager", "captures", "replays")}
            for name, st in ctx.pipeline.program_stats().items()}


def host_cpu():
    """(all cores' jiffies, of them stolen by the hypervisor, this process's
    CPU seconds): the host's share of the noise, read over the window."""
    import resource

    try:
        with open("/proc/stat") as f:
            f_ = [int(v) for v in f.readline().split()[1:]]
        total, steal = sum(f_[:8]), f_[7]
    except (OSError, ValueError, IndexError):
        total = steal = 0
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return total, steal, ru.ru_utime + ru.ru_stime


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(spec: Spec, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", control: bool = False,
             workers=None, breakage=None):
    """One run; returns (result dict, check lines). ``breakage``, for the
    harness's own tests, wraps the program's context before the window."""
    import torch

    import rav1e_tpu_torch as r
    from rav1e_tpu_torch.utils import trace as trace_mod

    c, tr = spec.config, spec.traffic
    width, height = c["width"], c["height"]
    make_config = lambda: r.Config(enc=encoder_config(r, c), device=device)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    # every scene of the stream's round, drawn so that nothing is made in
    # the window
    clip = Clip(tr["content"], width, height, seed, device)
    clip.draw_all()
    fixed = c["fixed_frames"]

    warm = warm_up(r, make_config, tr, seed, width, height, device)
    obs = Observations(fixed_frames=fixed)
    bound_per_launch = None
    if trace and on_card:
        bound_per_launch, rounds = grid_search_rounds(clip, device)
        log(f"grid_search rounds of one motion search (n, seeds, R, blk): "
            f"{rounds}")
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    ctx = make_config().new_context()
    if breakage:
        ctx = breakage(ctx)
    stream = Stream(r, ctx, clip, seconds, fixed, [] if trace else None)
    dtrace = None
    mark_s = None
    if trace:
        trace_mod.trace_enable()
        trace_mod.reset()
        mark_s = clock_mark(trace_mod)
        if on_card:
            from encbench.devtrace import DeviceTrace
            dtrace = DeviceTrace()
    runs0 = {}

    def on_start():
        runs0.update(program_runs(ctx))
        if dtrace:
            dtrace.start()

    obs.setup_s = time.monotonic() - t_start
    cpu0 = host_cpu()
    sent = stream.run(on_start)
    cpu1 = host_cpu()
    if on_card:
        torch.cuda.synchronize()
    if dtrace:
        dtrace.stop()
    obs.t0, obs.t1 = stream.t0, stream.t1
    obs.window_s = stream.t1 - stream.t0
    obs.setup_s = stream.t0 - t_start
    obs.frames = stream.window_frames
    recv = {}
    for p, t in stream.packets:
        if p.show_frame and p.input_frameno not in recv:
            recv[p.input_frameno] = t
    obs.latencies_s = [recv[f] - stream.sent_at[f]
                       for f in stream.shown[: stream.window_frames]]
    if trace:
        obs.spans = [s for s in span_list(trace_mod, mark_s)
                     if s[2] > obs.t0 and s[1] < obs.t1]
        obs.api_calls = [c for c in stream.calls
                         if c[2] > obs.t0 and c[1] < obs.t1]
        trace_mod.reset()
        runs1 = program_runs(ctx)
        obs.program_runs = {
            n: {k: v - runs0.get(n, {}).get(k, 0) for k, v in d.items()}
            for n, d in runs1.items()}
        if dtrace:
            obs.device_events = dtrace.events
        if bound_per_launch is not None:
            obs.kernel_bound_s = {"grid_search": bound_per_launch}
    obs.fixed_bytes, obs.fixed_psnr_y_db = fixed_set(stream, fixed, width,
                                                     height)
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    log(f"window: {obs.frames} frames in {obs.window_s:.6f} s; {sent} sent, "
        f"{len(stream.packets)} packets in all; set-up {obs.setup_s:.6f} s "
        f"(warm-up {warm} frames)")
    d_total, d_steal = cpu1[0] - cpu0[0], cpu1[1] - cpu0[1]
    log(f"host over the stream: {100.0 * d_steal / max(d_total, 1):.3f}% of "
        f"all cores' time stolen, this process {cpu1[2] - cpu0[2]:.3f} CPU s")

    # the program's state goes before the reference runs
    packets = [(p.data, p.rec, p.frame_type == r.FrameType.KEY)
               for p, _t in stream.packets]
    shown, hidden = list(stream.shown), list(stream.hidden)
    del ctx, stream
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks, details = checkmod.run_check(packets, shown, hidden, workers,
                                         control)
    failed = (checks["undecodable"]["value"]
              + checks["order_errors"]["value"]
              + details["failed_packets"])
    log(f"check: {len(packets)} packets in {details['segments']} segments"
        + (f"; first faults {details['first_fault']}"
           if details["first_fault"] else ""))
    if control:
        log(f"control: the reconstruction compared at {c['bit_depth'] - 1} "
            f"bits")

    metrics = {}
    for m in spec.metrics:
        v = reader(m["name"])(obs)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    log(f"frame latency (send_frame to its packet) over "
        f"{len(obs.latencies_s)} window frames")
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": checkmod.passed(checks) and len(packets) > 0,
              "attempted": len(packets), "failed": int(failed),
              "metrics": metrics, "device": dev}
    if trace and obs.device_events is not None:
        from encbench import devtrace

        busy = devtrace.busy_s(obs.device_events, obs.t0, obs.t1)
        dev["busy_s"] = busy
        dev["window_s"] = obs.window_s
        ops = devtrace.by_name(obs.device_events, obs.t0, obs.t1)
        top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:10]
        gaps = devtrace.idle_gaps(obs.device_events, obs.t0, obs.t1)[:10]
        result["breakdown"] = {
            "device_ops": [[n, s] for n, (s, _c) in top],
            "idle_gaps": [[devtrace.host_activity(obs.spans, obs.api_calls,
                                                  (a + b) / 2), b - a]
                          for a, b in gaps],
        }
    result["checks"] = checks
    lines = [f"check {k} {v['value']} limit {v['limit']}"
             for k, v in checks.items()]
    return result, lines
