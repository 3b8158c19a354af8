#!/usr/bin/env python3
"""End-to-end numbers of two trees of the PyTorch port on one CUDA card, in
turns: for the replayed programs of ``rav1e_tpu_torch/device/graphs.py``
(the chain, the frame analysis, the standalone CDEF stage, and where the
tree has it the store that keeps them for the process) against another
tree, such as the parent.

    python3 tools/chain_graphs_bench.py --other DIR

DIR is another checkout of the repository (for example the parent commit,
unpacked with ``git archive`` under ``build/``).  Each tree runs in a
process of its own, from its own directory and with its own chip_smoke.py,
in the order other, this, this, other.  A process builds the tree's kernels
and host coder, encodes 4 frames of a 256x128 pan as a warm-up (other
keys than the 1080p ones, so the first 1080p context meets its keys anew
in either tree), and then measures:

- slice: a new default context (speed 6, chain on) over chip_smoke.py's
  16 frames of 1080p, host clock to a synchronize: frames/s, the
  ``chain_dispatch`` span (count, mean and total ms), ``chain_replay_code``
  and ``device_analysis``, and the graph counts and pool bytes of each
  runner the pipeline has (``_chain_programs``, ``_analysis_programs``,
  ``_cdef_programs``); then the same in a second new context
  (``slice_2``), and in a third under torch.profiler: frames/s and the
  device's idle share (1 - the union of its activity intervals over the
  wall time);
- chain off: the 16 frames with ``device_chain=False`` (the standalone CDEF
  stage on every frame): frames/s, the ``cdef_rdo_device`` and
  ``device_analysis`` spans, and the analysis and CDEF runners' graph
  counts;
- bench: ``python3 bench_torch.py`` of the tree: its 1080p-normalised
  frames/s; then its layout in this process (a 6-frame warm-up context and
  three timed repetitions, each a new context over the 640x384 16-frame
  clip): each repetition's seconds, and a fourth repetition under the
  profiler: frames/s and idle share;
- gop, each run in a process of its own after the same warm-up:
  chip_smoke.py's ``gop_run`` over 96 frames, keyframes every 16 (6
  chunks), with 3 GOP slots and serially, then both under the profiler:
  frames/s and host CPU seconds of each, and the idle share under the
  profiler.

Prints one line per tree's turn with the card's name and power limit; writes
every number to chiprun_out/chain_graphs_bench.json, and each process's
parts as they end, with its progress, to chiprun_out/chain_graphs_bench_N.*
(a process that runs past its limit keeps the parts it finished).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def worker(path: Path) -> dict:
    """The measurements of the tree in the current directory, written to
    ``path`` after each part (a part that hangs leaves the ones before)."""
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
    warm = cs.synth_clip(256, 128, 4, np.random.default_rng(cs.SEED))
    cs.encode(cs.slice_config(r, width=256, height=128).new_context(), warm,
              r)
    out = {"tree": os.getcwd(), "card": cs.gpu_info()}
    t_start = time.monotonic()

    def save(part):
        path.write_text(json.dumps(out))
        print(f"{part} done at {time.monotonic() - t_start:.1f} s",
              file=sys.stderr, flush=True)

    for label, profiled in (("slice", False), ("slice_2", False),
                            ("slice_profiled", True)):
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
               "spans": {k: spans[k] for k in SPANS if k in spans},
               "graphs": graphs_of(ctx)}
        if profiled:
            busy_ms, _streams = cs.device_activity(prof)
            run["idle_share"] = 1.0 - busy_ms / (wall * 1e3)
        out[label] = run
        del ctx, pkts
        save(label)

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
        "graphs": graphs_of(ctx)}
    del ctx
    save("chain_off")

    res = subprocess.run([sys.executable, "bench_torch.py"],
                         capture_output=True, text=True, timeout=900,
                         check=True)
    out["bench"] = json.loads(res.stdout.strip().splitlines()[-1])["value"]

    import bench_torch
    import reference_cells

    cell = reference_cells.CELLS["bench clip"]
    runs = bench_torch.clip_runs(cell)

    def bench_context():
        return r.Config(enc=reference_cells.encoder_config(r, cell),
                        device="cuda").new_context()

    def bench_run(ctx, clip):
        frames = [bench_torch._frame(ctx, planes) for planes in clip]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for f in frames:
            ctx.send_frame(f)
        reference_cells.drain(ctx, r)
        torch.cuda.synchronize()
        return time.monotonic() - t0

    bench_run(bench_context(), runs[0])
    out["bench_reps_s"] = [bench_run(bench_context(), clip)
                           for clip in runs[1:]]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = bench_run(bench_context(), runs[1])
    busy_ms, _streams = cs.device_activity(prof)
    out["bench_profiled"] = {"fps": len(runs[1]) / wall,
                             "idle_share": 1.0 - busy_ms / (wall * 1e3)}
    save("bench")

    store = getattr(importlib.import_module(
        "rav1e_tpu_torch.device.graphs"), "STORE", None)
    if store is not None:
        st = store.stats("cuda")
        out["store"] = {"sets": st["sets"], "pool_bytes": st["pool_bytes"]}
    save("store")
    return out


def gop_worker(path: Path, slots: int, profiled: bool) -> None:
    """One channel over the 96 frames, ``slots`` GOP slots (0: serial),
    after the 256x128 warm-up, in a process of its own: the parent's
    finished contexts keep their graph pools until a collection, and
    several 96-frame channels in one process ran the card out of memory."""
    import numpy as np
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    import rav1e_tpu_torch as r
    from rav1e_tpu_torch.device import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.lib()
    warm = cs.synth_clip(256, 128, 4, np.random.default_rng(cs.SEED))
    cs.encode(cs.slice_config(r, width=256, height=128).new_context(), warm,
              r)
    clip = cs.synth_clip(cs.WIDTH, cs.HEIGHT, GOP_FRAMES,
                         np.random.default_rng(cs.SEED))
    run = cs.gop_run(r, slots, clip, profiled)
    path.write_text(json.dumps({
        "fps": run["fps"], "cpu_s": run["cpu"], "wall_s": run["wall"],
        "idle_share": run.get("idle")}))


def graphs_of(ctx) -> dict:
    """The pipeline's runners' stats, and its own runs where the tree
    counts them."""
    p = ctx.pipeline
    out = {name: getattr(p, name).stats() for name in RUNNERS
           if hasattr(p, name)}
    if hasattr(p, "program_stats"):
        out["own"] = {k: {m: v for m, v in st.items() if m != "set"}
                      for k, st in p.program_stats().items()}
    return out


GOP_FRAMES, GOP_SLOTS = 96, 3  # 6 chunks of 16 frames, on 3 slots
# the slice's spans kept: the chain's dispatch and replay coder, and the
# analysis's fetch or synchronous run
SPANS = ("chain_dispatch", "chain_replay_code", "device_analysis")
# the pipeline's runners of replayed programs (device/graphs.py), where the
# tree has them
RUNNERS = ("_chain_programs", "_analysis_programs", "_cdef_programs")


def line(label, m) -> str:
    try:
        return full_line(label, m)
    except KeyError:  # a part that did not end: its parts before, raw
        return f"{label} (incomplete): {json.dumps(m)}"


def full_line(label, m) -> str:
    def brief(g):
        return {name: ({k: v for k, v in st.items() if k != "by_key"}
                       if name != "own" else st) for name, st in g.items()}

    parts = []
    for key in ("slice", "slice_2", "slice_profiled"):
        s, sp = m[key], m[key]["spans"]
        cd = sp.get("chain_dispatch", {})
        da = sp.get("device_analysis", {})
        parts.append(
            f"{key} {s['fps']:.4f} frames/s"
            + (f", idle share {s['idle_share']:.6f}" if "idle_share" in s
               else "")
            + f", chain_dispatch count={cd.get('count')} mean_ms="
            f"{cd.get('mean_ms')} total_ms={cd.get('total_ms')}, "
            f"device_analysis count={da.get('count')} mean_ms="
            f"{da.get('mean_ms')}, graphs {brief(s['graphs'])}")
    off = m["chain_off"]
    cdef = off["spans"].get("cdef_rdo_device", {})
    parts.append(f"chain off {off['fps']:.4f} frames/s, cdef_rdo_device "
                 f"count={cdef.get('count')} mean_ms={cdef.get('mean_ms')},"
                 f" graphs {brief(off['graphs'])}")
    for key in ("gop_3", "gop_0", "gop_3_profiled", "gop_0_profiled"):
        g = m[key]
        if g is None:
            parts.append(f"{key} failed")
            continue
        parts.append(f"{key} {g['fps']:.4f} frames/s (host CPU "
                     f"{g['cpu_s']:.3f} s" + (
                         f", idle share {g['idle_share']:.6f}"
                         if g["idle_share"] is not None else "") + ")")
    parts.append(f"bench_torch {m['bench']}; in process, repetitions "
                 + ", ".join(f"{x:.3f}" for x in m["bench_reps_s"])
                 + f" s, profiled {m['bench_profiled']['fps']:.4f} frames/s "
                 f"at 640x384, idle share "
                 f"{m['bench_profiled']['idle_share']:.6f}")
    if "store" in m:
        parts.append(f"store {m['store']}")
    return f"{label}: " + "; ".join(parts)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, help="another checkout to compare")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--gop", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--profiled", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker and args.gop is not None:
        gop_worker(args.worker, args.gop, args.profiled)
        return 0
    if args.worker:
        worker(args.worker)
        return 0
    if args.other is None:
        ap.error("--other DIR is required")
    trees = [("other", args.other.resolve()), ("this", HERE),
             ("this", HERE), ("other", args.other.resolve())]
    outdir = HERE / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    results = []
    for i, (label, tree) in enumerate(trees):
        t0 = time.monotonic()
        part = outdir / f"chain_graphs_bench_{i}.json"
        m, rc = run_worker(tree, part, [], outdir / f"chain_graphs_bench_{i}.log")
        for profiled in (False, True):
            for slots in (GOP_SLOTS, 0):
                key = f"gop_{slots}" + ("_profiled" if profiled else "")
                g, grc = run_worker(
                    tree, outdir / f"chain_graphs_bench_{i}_{key}.json",
                    ["--gop", str(slots)] + ["--profiled"] * profiled,
                    outdir / f"chain_graphs_bench_{i}_{key}.log")
                m[key] = g or None
                rc = rc if grc == 0 else grc
        m.update(label=label, seconds=time.monotonic() - t0, rc=rc)
        results.append(m)
        print(line(label, m) + f" (exit {rc}, {m['seconds']:.1f} s, "
              f"{m.get('card')})", flush=True)
    (outdir / "chain_graphs_bench.json").write_text(
        json.dumps(results, indent=1))
    return 0 if all(m["rc"] == 0 for m in results) else 1


def run_worker(tree, part, args, log_path):
    """A worker process in ``tree`` writing ``part``: (what it wrote, its
    exit code or "timeout")."""
    part.unlink(missing_ok=True)
    with open(log_path, "w") as log:
        try:
            rc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()),
                 "--worker", str(part)] + args,
                cwd=tree, stdout=log, stderr=log, timeout=WORKER_S,
                env=dict(os.environ, PYTHONPATH=str(tree))).returncode
        except subprocess.TimeoutExpired:
            rc = "timeout"
    return (json.loads(part.read_text()) if part.exists() else {}), rc


# a worker's time limit: the parts it finished by then are kept
WORKER_S = 600


if __name__ == "__main__":
    sys.exit(main())
