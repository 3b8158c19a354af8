#!/usr/bin/env python3
"""End-to-end numbers of two trees of the PyTorch port on one CUDA card, in
turns: for the replayed programs of ``rav1e_tpu_torch/device/graphs.py``
(the chain, the frame analysis, the standalone CDEF stage) against another
tree, such as the parent.

    python3 tools/chain_graphs_bench.py --other DIR

DIR is another checkout of the repository (for example the parent commit,
unpacked with ``git archive`` under ``build/``).  Each tree runs in a
process of its own, from its own directory and with its own chip_smoke.py,
in the order other, this, this, other.  A process builds the tree's kernels
and host coder, encodes the first 4 frames of chip_smoke.py's 1080p pan as
a warm-up, and then measures:

- slice: a fresh default context (speed 6, chain on) over the 16 frames,
  host clock to a synchronize: frames/s, the ``chain_dispatch`` span (count,
  mean and total ms), ``chain_replay_code`` and ``device_analysis``; and
  the graph counts and pool bytes of each runner the tree's pipeline has
  (``_chain_programs``, ``_analysis_programs``, ``_cdef_programs``);
- slice profiled: the same under torch.profiler: frames/s and the device's
  idle share (1 - the union of its activity intervals over the wall time);
- chain off: the 16 frames with ``device_chain=False`` (the standalone CDEF
  stage on every frame): frames/s, the ``cdef_rdo_device`` and
  ``device_analysis`` spans, and the analysis and CDEF runners' graph
  counts;
- gop: chip_smoke.py's ``gop_run`` over 48 frames, keyframes every 16, with
  3 GOP slots and serially: frames/s and host CPU seconds of each, then the
  serial channel again under the profiler: frames/s and idle share;
- bench: ``python3 bench_torch.py`` of the tree: its 1080p-normalised
  frames/s; then its first timed repetition (a new context over the
  640x384 16-frame clip) under the profiler: frames/s and idle share.

Prints the card's name and power limit and one line per process; writes
every number to chiprun_out/chain_graphs_bench.json.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def worker() -> dict:
    """The measurements of the tree in the current directory."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    import rav1e_tpu_torch as r
    from rav1e_tpu_torch import native
    from rav1e_tpu_torch.device import _build
    from rav1e_tpu_torch.utils import trace

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.lib()
    if native.get_lib() is None:
        cs.fail("the host coder's native library did not build")
    clip = cs.synth_clip(cs.WIDTH, cs.HEIGHT, cs.NFRAMES,
                         np.random.default_rng(cs.SEED))
    trace.trace_enable()
    cs.encode(cs.slice_config(r).new_context(), clip[:4], r)
    out = {"tree": os.getcwd(), "card": cs.gpu_info()}

    for profiled in (False, True):
        ctx = cs.slice_config(r).new_context()
        trace.reset()
        torch.cuda.synchronize()
        prof = (profile(activities=[ProfilerActivity.CUDA]) if profiled
                else contextlib.nullcontext())
        with prof:
            t0 = time.monotonic()
            pkts = cs.encode(ctx, clip, r)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        spans = trace.stage_summary()
        run = {"fps": len(clip) / wall, "packets": len(pkts),
               "spans": {k: spans[k] for k in SPANS if k in spans}}
        if profiled:
            busy_ms, _streams = cs.device_activity(prof)
            run["idle_share"] = 1.0 - busy_ms / (wall * 1e3)
        for name in RUNNERS:
            programs = getattr(ctx.pipeline, name, None)
            if programs is not None:
                run.setdefault("graphs", {})[name] = programs.stats()
        out["slice_profiled" if profiled else "slice"] = run
        del ctx, pkts

    ctx = cs.slice_config(r, chain=False).new_context()
    trace.reset()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    cs.encode(ctx, clip, r)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    spans = trace.stage_summary()
    out["chain_off"] = {
        "fps": len(clip) / wall,
        "spans": {k: spans[k] for k in ("cdef_rdo_device", "device_analysis")
                  if k in spans},
        "graphs": {name: getattr(ctx.pipeline, name).stats()
                   for name in RUNNERS[1:]
                   if hasattr(ctx.pipeline, name)}}
    del ctx

    gop_clip = cs.synth_clip(cs.WIDTH, cs.HEIGHT, cs.GOP_FRAMES,
                             np.random.default_rng(cs.SEED))
    for slots in (cs.GOP_SLOTS, 0):
        run = cs.gop_run(r, slots, gop_clip, False)
        out[f"gop_{slots}"] = {"fps": run["fps"], "cpu_s": run["cpu"],
                               "wall_s": run["wall"]}
    run = cs.gop_run(r, 0, gop_clip, True)
    out["gop_0_profiled"] = {"fps": run["fps"], "idle_share": run["idle"]}
    res = subprocess.run([sys.executable, "bench_torch.py"],
                         capture_output=True, text=True, timeout=900,
                         check=True)
    out["bench"] = json.loads(res.stdout.strip().splitlines()[-1])["value"]

    import bench_torch
    import reference_cells

    cell = reference_cells.CELLS["bench clip"]
    clip = bench_torch.clip_runs(cell)[1]
    ctx = r.Config(enc=reference_cells.encoder_config(r, cell),
                   device="cuda").new_context()
    frames = [bench_torch._frame(ctx, planes) for planes in clip]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for f in frames:
            ctx.send_frame(f)
        reference_cells.drain(ctx, r)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    busy_ms, _streams = cs.device_activity(prof)
    out["bench_profiled"] = {"fps": len(clip) / wall,
                             "idle_share": 1.0 - busy_ms / (wall * 1e3)}
    return out


# the slice's spans kept: the chain's dispatch and replay coder, and the
# analysis's fetch or synchronous run
SPANS = ("chain_dispatch", "chain_replay_code", "device_analysis")
# the pipeline's runners of replayed programs (device/graphs.py), where the
# tree has them
RUNNERS = ("_chain_programs", "_analysis_programs", "_cdef_programs")


def line(label, m) -> str:
    s, sp = m["slice"], m["slice"]["spans"]
    cd = sp.get("chain_dispatch", {})
    da = sp.get("device_analysis", {})
    graphs = {name: {k: v for k, v in g.items() if k != "by_key"}
              for name, g in s.get("graphs", {}).items()}
    off = m["chain_off"]
    cdef = off["spans"].get("cdef_rdo_device", {})
    off_graphs = {name: {k: v for k, v in g.items() if k != "by_key"}
                  for name, g in off["graphs"].items()}
    return (f"{label}: slice {s['fps']:.4f} frames/s, chain_dispatch "
            f"count={cd.get('count')} mean_ms={cd.get('mean_ms')} "
            f"total_ms={cd.get('total_ms')}, device_analysis "
            f"count={da.get('count')} mean_ms={da.get('mean_ms')}; profiled "
            f"{m['slice_profiled']['fps']:.4f} frames/s, idle share "
            f"{m['slice_profiled']['idle_share']:.6f}; chain off "
            f"{off['fps']:.4f} frames/s, cdef_rdo_device count="
            f"{cdef.get('count')} mean_ms={cdef.get('mean_ms')}, graphs "
            f"{off_graphs}; gop 3 slots "
            f"{m['gop_3']['fps']:.4f} frames/s (host CPU "
            f"{m['gop_3']['cpu_s']:.3f} s), serial {m['gop_0']['fps']:.4f} "
            f"frames/s (host CPU {m['gop_0']['cpu_s']:.3f} s), serial "
            f"profiled {m['gop_0_profiled']['fps']:.4f} frames/s, idle share "
            f"{m['gop_0_profiled']['idle_share']:.6f}; bench_torch "
            f"{m['bench']}, profiled {m['bench_profiled']['fps']:.4f} "
            f"frames/s at 640x384, idle share "
            f"{m['bench_profiled']['idle_share']:.6f}; graphs {graphs}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, help="another checkout to compare")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print("RESULT " + json.dumps(worker()), flush=True)
        return 0
    if args.other is None:
        ap.error("--other DIR is required")
    trees = [("other", args.other.resolve()), ("this", HERE),
             ("this", HERE), ("other", args.other.resolve())]
    results = []
    for label, tree in trees:
        t0 = time.monotonic()
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker"],
            cwd=tree, capture_output=True, text=True, timeout=1500,
            env=dict(os.environ, PYTHONPATH=str(tree)))
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        m = json.loads(next(ln for ln in res.stdout.splitlines()
                            if ln.startswith("RESULT "))[7:])
        m["label"], m["seconds"] = label, time.monotonic() - t0
        results.append(m)
        print(line(label, m) + f" ({m['seconds']:.1f} s, {m['card']})",
              flush=True)
    out = HERE / "chiprun_out" / "chain_graphs_bench.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
