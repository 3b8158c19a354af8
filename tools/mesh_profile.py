#!/usr/bin/env python3
"""The analysis mesh against the unsharded analysis on one CUDA card.

    python3 tools/mesh_profile.py [--slots 4] [--reps 5] [--frames 4]

On chip_smoke.py's synthetic 1080p pan, in turns (unsharded, mesh, mesh,
unsharded) after a warm-up of each, with the mesh made of ``--slots`` slots
of cuda:0 (each band on a stream of its own):

1. the analysis alone (``analysis.analyze_frame``) of a key, a forward-inter
   and a bidirectional frame: host-clock ms per call (ending in a
   synchronize) and the kernels' launches per call; then each once more
   under torch.profiler: the device-busy share of the profiled wall time
   (union of CUDA kernel and memcpy intervals) and the most CUDA streams
   busy at once;
2. a ``--frames``-frame chain-on encode through the default preset: frames/s
   and launches, and the same two profiler numbers.

Prints the card's name and power limit first.  Every number is this run's.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def profiled(fn):
    """(device-busy share of the wall time, the most streams busy at once)
    of one call of fn under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t) * 1e3
    busy_ms, streams = chip_smoke.device_activity(prof)
    return busy_ms / wall_ms, streams


def timed(fn, reps):
    """(host-clock ms per call, launches per call) over reps calls."""
    import torch

    from rav1e_tpu_torch.device import kernels

    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.monotonic()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    ms = (time.monotonic() - t) * 1e3 / reps
    return ms, {k: v / reps for k, v in kernels.LAUNCHES.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--frames", type=int, default=4)
    args = ap.parse_args()

    import numpy as np
    import torch

    import rav1e_tpu_torch as r
    from rav1e_tpu_torch import tables
    from rav1e_tpu_torch.device import analysis
    from rav1e_tpu_torch.parallel import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.gpu_info(), flush=True)
    clip = chip_smoke.synth_clip(chip_smoke.WIDTH, chip_smoke.HEIGHT,
                                 max(args.frames, 3),
                                 np.random.default_rng(chip_smoke.SEED))
    mesh = make_mesh(args.slots, devices=["cuda:0"] * args.slots)
    qi = chip_smoke.QUANTIZER
    lam = 0.12 * (tables.ac_q(qi, 0, 8) / 8.0) ** 2
    y = [clip[i][0] for i in range(3)]
    frames = {"key": (y[1], None, None), "inter": (y[1], y[0], None),
              "inter+bwd": (y[1], y[0], y[2])}
    orig = analysis._analysis_mesh
    turns = (("unsharded", None), ("mesh", mesh), ("mesh", mesh),
             ("unsharded", None))
    try:
        for label, m in turns:
            analysis._analysis_mesh = lambda device, m=m: m
            for kind, planes in frames.items():
                def call(planes=planes):
                    analysis.analyze_frame(*planes, qi, lam, 8,
                                           device="cuda")

                call()  # warm-up
                ms, launches = timed(call, args.reps)
                share, streams = profiled(call)
                print(f"analysis {kind:10s} {label:9s} {ms:.3f} ms/call, "
                      f"device busy {share:.4f} of the wall, {streams} "
                      f"streams busy at once, launches/call {launches}",
                      flush=True)
        sub = clip[:args.frames]
        for m in (None, mesh):  # warm-up
            chip_smoke.mesh_encode(r, sub[:2], m)
        for label, m in turns:
            pkts, launches, s, _ = chip_smoke.mesh_encode(r, sub, m)
            share, streams = profiled(
                lambda: chip_smoke.mesh_encode(r, sub, m))
            print(f"encode {len(sub)} frames {label:9s} "
                  f"{len(sub) / s:.4f} frames/s, launches {launches}, "
                  f"device busy {share:.4f} of the wall, {streams} streams "
                  f"busy at once, {len(pkts)} packets", flush=True)
    finally:
        analysis._analysis_mesh = orig
    return 0


if __name__ == "__main__":
    sys.exit(main())
