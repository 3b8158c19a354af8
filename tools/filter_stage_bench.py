#!/usr/bin/env python3
"""The device filter stage (deblock + CDEF) of two trees of the PyTorch
port on one CUDA card, in turns: this tree against another, such as the
parent.

    python3 tools/filter_stage_bench.py --other DIR

DIR is another checkout of the repository (for example the parent commit,
unpacked with ``git archive`` under ``build/``).  Each tree runs in a
process of its own, from its own directory and with its own chip_smoke.py,
in the order other, this, this, other.  A process builds the tree's kernels
and measures:

- chain: chip_smoke.py's bidirectional 1080p chain frame (clip frame 2
  against 0, 4 and 8) through a ChainPrograms, its key's second frame
  captured and replayed (``chain_graph_check``): each stage's replay
  timed by CUDA events (20 replays, median of 5) and profiled (kernels,
  device-busy ms), stage 4 (deblock + CDEF) eagerly too, the five stages'
  device-busy summed (a chain frame's), and the runner's graph pool bytes;
- cdef: a CdefPrograms over one 1080p 4:2:0 key (clip frame 1 as the
  reconstruction, frame 2 as the source, half the cells skipped, the
  slice's strength lists), run three times (eager, capture, replay): the
  replay's CUDA-event ms and device-busy ms and the pool's bytes;
- slice: a new default context over 16 frames of 1080p (chain on): frames/s
  and each runner's pool bytes in its set; chain off: the first 4 frames
  with ``device_chain=False``: the ``cdef_rdo_device`` span (count, total
  ms).

Prints one line per tree's turn with the card's name and power limit;
writes every number to chiprun_out/filter_stage_bench.json.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def _median_ms(cs, fn, reps=20, runs=5):
    import numpy as np

    return float(np.median([cs.cuda_ms(fn, reps) for _ in range(runs)]))


def worker() -> dict:
    """The measurements of the tree in the current directory."""
    import numpy as np
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    import rav1e_tpu_torch as r
    from rav1e_tpu_torch import tables
    from rav1e_tpu_torch.device import _build
    from rav1e_tpu_torch.device.filters import _strength_lists
    from rav1e_tpu_torch.device.graphs import CdefPrograms
    from rav1e_tpu_torch.ops.cdef import cdef_strengths_fast
    from rav1e_tpu_torch.utils import trace

    torch.backends.cuda.matmul.allow_tf32 = False
    t = time.monotonic()
    _build.lib()
    out = {"tree": os.getcwd(), "build_s": time.monotonic() - t,
           "gpu": cs.gpu_info()}
    dev = "cuda"
    clip = cs.synth_clip(cs.WIDTH, cs.HEIGHT, cs.NFRAMES,
                         np.random.default_rng(cs.SEED))

    # chain: the five stages replayed, stage 4 eagerly too
    case = cs.chain_case(clip, dev)
    case_b = cs.chain_case(clip, dev, cs.CHAIN_FRAMES_B)
    got, calls = cs.chain_calls(case, dev)
    got_b, _ = cs.chain_calls(case_b, dev)
    keys = [k for _n, _c, ks in calls for k in ks]
    programs, _host = cs.chain_graph_check(case, case_b, got, got_b, keys,
                                           dev)
    graphs = programs.key(case["geom"], case["y_list"],
                          case["uv_list"]).graphs
    stages = {}
    for (name, call, _k), graph in zip(calls, graphs):
        kern, _copies, _h, busy = cs.profile_call(graph.replay)
        stages[name] = {"replay_ms": _median_ms(cs, graph.replay),
                        "replay_kernels": kern, "replay_busy_ms": busy}
        if name == "deblock+CDEF":
            kern, _copies, _h, busy = cs.profile_call(call)
            stages[name].update(eager_ms=_median_ms(cs, call, 5),
                                eager_kernels=kern, eager_busy_ms=busy)
    out["chain"] = {"stages": stages, "pool_bytes": programs.pool_bytes(),
                    "frame_busy_ms": sum(v["replay_busy_ms"]
                                         for v in stages.values())}
    del programs, graphs, got, got_b, calls
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # cdef: one 1080p 4:2:0 key of the standalone stage
    rng = np.random.default_rng(cs.SEED)
    nby, nbx = cs.HEIGHT // 8, cs.WIDTH // 8
    planes, rec, src = [], [], []
    for p, (ys, xs) in enumerate(((8, 8), (4, 4), (4, 4))):
        planes.append((ys, xs, nby * ys, nbx * xs))
        rp = np.pad(clip[1][p], 2, mode="edge")
        rec.append(np.ascontiguousarray(rp[: nby * ys + 4, : nbx * xs + 4]))
        src.append(np.ascontiguousarray(clip[2][p][: nby * ys, : nbx * xs]))
    filt = rng.random((nby, nbx)) >= 0.5
    qi = cs.QUANTIZER
    y_str, uv_str = _strength_lists(
        *cdef_strengths_fast(tables.ac_q(qi, 0, 8)))
    grid = (nby, nbx, -(-cs.HEIGHT // 64), -(-cs.WIDTH // 64), cs.WIDTH,
            cs.HEIGHT)
    runner = CdefPrograms(dev)

    def run():
        return runner.run(planes, grid, 3, 8, rec, src, filt, y_str, uv_str)

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    graph = next(iter(runner._keys.values())).graphs[0]
    kern, _copies, _h, busy = cs.profile_call(graph.replay)
    out["cdef"] = {"replay_ms": _median_ms(cs, graph.replay),
                   "replay_kernels": kern, "replay_busy_ms": busy,
                   "pool_bytes": runner.pool_bytes(),
                   "stats": {k: v for k, v in runner.stats().items()
                             if k != "by_key"}}
    del runner, graph
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # the slice, chain on and off
    trace.trace_enable()
    for label, frames, chain in (("slice", clip, True),
                                 ("chain_off", clip[:4], False)):
        trace.reset()
        ctx = cs.slice_config(r, chain=chain).new_context()
        torch.cuda.synchronize()
        t = time.monotonic()
        pkts = cs.encode(ctx, frames, r)
        torch.cuda.synchronize()
        wall = time.monotonic() - t
        spans = trace.stage_summary()
        out[label] = {
            "frames": len(frames), "packets": len(pkts),
            "fps": len(frames) / wall,
            "spans": {k: spans[k] for k in ("chain_dispatch",
                                            "cdef_rdo_device",
                                            "device_analysis") if k in spans},
            "pools": {k: st["set"]["pool_bytes"] for k, st in
                      ctx.pipeline.program_stats().items()},
        }
        del ctx
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="another checkout of the repository")
    ap.add_argument("--worker", action="store_true",
                    help="measure the tree in the current directory")
    ap.add_argument("--out", help="the worker's JSON file")
    args = ap.parse_args()
    if args.worker:
        res = worker()
        Path(args.out).write_text(json.dumps(res))
        return 0
    trees = [Path(args.other).resolve(), HERE] if args.other else [HERE]
    order = trees + trees[::-1] if args.other else trees
    outdir = HERE / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    results = []
    for i, tree in enumerate(order):
        path = outdir / f"filter_stage_bench_{i}.json"
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             "--out", str(path)], cwd=tree, timeout=1500)
        if proc.returncode != 0:
            print(f"turn {i} ({tree}): exit code {proc.returncode}",
                  flush=True)
            return proc.returncode
        res = json.loads(path.read_text())
        results.append(res)
        st4 = res["chain"]["stages"]["deblock+CDEF"]
        print(f"turn {i} {tree.name}: stage 4 replay "
              f"{st4['replay_ms']:.4f} ms (busy {st4['replay_busy_ms']:.4f},"
              f" {st4['replay_kernels']} kernels), eager "
              f"{st4['eager_ms']:.4f} ms; chain frame busy "
              f"{res['chain']['frame_busy_ms']:.4f} ms; chain pool "
              f"{res['chain']['pool_bytes']} B; CDEF replay "
              f"{res['cdef']['replay_ms']:.4f} ms, pool "
              f"{res['cdef']['pool_bytes']} B; slice "
              f"{res['slice']['fps']:.4f} frames/s, pools "
              f"{res['slice']['pools']}; chain-off cdef_rdo_device "
              f"{res['chain_off']['spans'].get('cdef_rdo_device')} "
              f"({res['gpu']})", flush=True)
    (outdir / "filter_stage_bench.json").write_text(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
