#!/usr/bin/env python3
"""Benchmark of the PyTorch port: end-to-end encode throughput, 1080p-normalized.

    python3 bench_torch.py [--device cpu] [--width W --height H --frames N]

bench.py's workload through ``rav1e_tpu_torch.Config(..., device="cuda")``:
the ``bench clip`` cell of reference_cells.py (640x384, 16 frames, q 120,
the default speed-6 preset with reordering, bench.py's seeded pan drawn
from ``default_rng(42)``), a 6-frame warm-up context (kernel builds, the
native coder, first launches; not timed), then three timed repetitions,
each with 16 new frames from the same generator, the best of which counts.
The frames of the first repetition are the cell's, whose packets
tests/data/torch_reference_packets.json holds from rav1e_tpu.  The
``--device`` and size options are for a smoke run on the CPU only: the
number is the card's.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}, with
vs_baseline against bench.py's assumed 30 frames/s of AVX2 rav1e at speed 6
and 1080p (BASELINE.md).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import reference_cells  # noqa: E402

BASELINE_1080P_FPS = 30.0  # bench.py's assumed AVX2 rav1e speed-6 1080p
REPS = 3


def _frame(ctx, planes):
    f = ctx.new_frame()
    for p, arr in zip(f.planes, planes):
        p.copy_from(arr)
    return f


def clip_runs(cell):
    """The warm-up's frames, then each timed repetition's, as bench.py draws
    them: one generator, one texture, the pan restarting with each run."""
    return reference_cells.pan_runs(
        cell["width"], cell["height"], [cell["warm_frames"]]
        + [cell["frames"]] * REPS, np.random.default_rng(cell["seed"]))


def main(argv=None):
    cell = dict(reference_cells.CELLS["bench clip"])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (a smoke run may ask for cpu)")
    ap.add_argument("--width", type=int, default=cell["width"])
    ap.add_argument("--height", type=int, default=cell["height"])
    ap.add_argument("--frames", type=int, default=cell["frames"])
    args = ap.parse_args(argv)
    import rav1e_tpu_torch as r

    cell.update(width=args.width, height=args.height, frames=args.frames)
    w, h, n = cell["width"], cell["height"], cell["frames"]

    def new_context():
        enc = reference_cells.encoder_config(r, cell)
        return r.Config(enc=enc, device=args.device).new_context()

    runs = clip_runs(cell)
    warm = new_context()
    for planes in runs[0]:
        warm.send_frame(_frame(warm, planes))
    reference_cells.drain(warm, r)

    best_dt = None
    for clip in runs[1:]:
        ctx = new_context()
        frames = [_frame(ctx, planes) for planes in clip]
        t0 = time.monotonic()
        for f in frames:
            ctx.send_frame(f)
        reference_cells.drain(ctx, r)
        dt = time.monotonic() - t0
        if best_dt is None or dt < best_dt:
            best_dt = dt

    fps_1080p = (w * h * n) / best_dt / (1920 * 1080)
    print(json.dumps({
        "metric": "encode throughput (1080p-normalized)",
        "value": round(fps_1080p, 4),
        "unit": "fps",
        "vs_baseline": round(fps_1080p / BASELINE_1080P_FPS, 5),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
