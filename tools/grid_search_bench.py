#!/usr/bin/env python3
"""Time the full-pel motion-search rounds of two trees of the PyTorch port on
one CUDA card, in turns.

    python3 tools/grid_search_bench.py --other DIR [--reps N]

DIR is another checkout of the repository (for example the parent commit,
unpacked with ``git archive``).  Each tree runs in its own process, in the
order other, this, this, other.  A process takes three 1080p frames of
chip_smoke.py's synthetic pan (64-padded to 1088x1920), records the four
``me._grid_search`` calls that ``me.me_field`` makes on the second against
the first, and times each
round, the whole ``me_field``, and the whole-frame analysis of an inter and
an inter+bwd frame (a third frame as the backward reference), three ways:

- event_ms: CUDA events around ``reps`` back-to-back calls, per call;
- host_ms: host clock around one call that ends in a synchronize, mean of
  ``reps``;
- busy_ms: device-busy time of one call under torch.profiler (the union of
  its kernels' intervals), with the number of kernels it launched.

Every process checks that its MVs equal the first process's, so the two
trees compute the same rounds.  Prints the card's name and power limit and
one line per round and tree; writes all numbers to
chiprun_out/grid_search_bench.json.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
NAMES = ["L2 R3 s2", "L2 R1 s1", "L1 R2 s1", "L0 R2 s1"]


def _smoke():
    """chip_smoke.py of this tree, for its clip and its card query."""
    spec = importlib.util.spec_from_file_location(
        "grid_bench_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _busy(fn):
    """(device-busy ms, kernels launched) of one call of fn."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    iv = sorted((e.time_range.start, e.time_range.end)
                for e in prof.events() if e.device_type == cuda)
    busy, end = 0, None
    for a, b in iv:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3, len(iv)


def _times(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / reps
    host = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host += time.perf_counter() - t0
    busy_ms, kernels = _busy(fn)
    return {"event_ms": event_ms, "host_ms": host * 1e3 / reps,
            "busy_ms": busy_ms, "kernels": kernels}


def worker(root: Path, reps: int, q: float) -> dict:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from rav1e_tpu_torch.device import analysis, me

    smoke = _smoke()
    clip = smoke.synth_clip(smoke.WIDTH, smoke.HEIGHT, 3,
                            np.random.default_rng(smoke.SEED))
    ref, cur, bwd = (analysis.upload_source_luma(f[0], "cuda").to(torch.int32)
                     for f in clip)

    calls = smoke.grid_search_rounds(cur, ref)
    mv = me.me_field(cur, ref, 8)
    real = me._grid_search
    outs = [real(*a) for a in calls]
    out = {"root": str(root), "rounds": []}
    for name, a, o in zip(NAMES, calls, outs):
        row = {"round": name, "n": int(a[0].shape[0]), "seeds": len(a[4])}
        row.update(_times(lambda a=a: real(*a), reps))
        out["rounds"].append(row)
    out["me_field"] = _times(lambda: me.me_field(cur, ref, 8), reps)
    qt = torch.tensor(q, dtype=torch.float32, device="cuda")
    lam = torch.tensor(0.12 * (q / 8.0) ** 2, dtype=torch.float32,
                       device="cuda")
    out["analysis inter"] = _times(lambda: analysis._frame_analysis(
        cur, ref, ref, ref, qt, lam, 8, True), reps)
    out["analysis inter+bwd"] = _times(lambda: analysis._frame_analysis(
        cur, ref, bwd, ref, qt, lam, 8, True, True), reps)
    out["mvs"] = [o.cpu().tolist() for o in outs] + [mv.cpu().tolist()]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, help="another checkout to compare")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--q", type=float, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        print(json.dumps(worker(args.worker, args.reps, args.q)), flush=True)
        return 0
    import torch

    sys.path.insert(0, str(HERE))
    from rav1e_tpu_torch import tables

    smoke = _smoke()
    # the analysis's AC quantizer at chip_smoke.py's q index, 8 bit
    q = float(tables.ac_q(smoke.QUANTIZER, 0, 8))
    if not torch.cuda.is_available():
        smoke.fail("no CUDA card")
    info = smoke.gpu_info()
    print(f"card: {info}", flush=True)
    trees = [("other", args.other.resolve()), ("this", HERE),
             ("this", HERE), ("other", args.other.resolve())]
    runs = []
    for label, root in trees:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             str(root), "--reps", str(args.reps), "--q", str(q)],
            cwd=root, capture_output=True, text=True, timeout=900,
            env=dict(os.environ, PYTHONPATH=str(root)),
        )
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            smoke.fail(f"worker for {root} exited {proc.returncode}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["tree"] = label
        runs.append(res)
    for r in runs[1:]:
        if r["mvs"] != runs[0]["mvs"]:
            smoke.fail(f"{r['tree']} tree's MVs differ from the first run's")
    print("tree   round              n     seeds  event_ms   host_ms   "
          "busy_ms  kernels")
    for r in runs:
        whole = [dict(r[k], round=k, n=0, seeds=0)
                 for k in ("me_field", "analysis inter", "analysis inter+bwd")]
        for row in r["rounds"] + whole:
            print(f"{r['tree']:6s} {row['round']:18s} {row['n']:5d} "
                  f"{row['seeds']:5d}  {row['event_ms']:.6f}  "
                  f"{row['host_ms']:.6f}  {row['busy_ms']:.6f}  "
                  f"{row['kernels']}", flush=True)
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    for r in runs:
        del r["mvs"]
    (out_dir / "grid_search_bench.json").write_text(json.dumps(
        {"card": info, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
