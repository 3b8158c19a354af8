#!/usr/bin/env python3
"""The analysis mesh against the unsharded analysis on one CUDA card.

    python3 tools/mesh_profile.py [--slots 4] [--reps 5] [--frames 4]

On chip_smoke.py's synthetic 1080p pan, in turns (unsharded, mesh, mesh,
unsharded) after a warm-up of each, with the mesh made of ``--slots`` slots
of cuda:0 (each band on a stream of its own):

1. the analysis alone (``analysis.analyze_frame_async`` and
   ``analyze_finish``) of a key, a forward-inter and a bidirectional frame,
   through one runner per turn (``device/graphs.AnalysisPrograms``, whose
   band runners replay one CUDA graph per slot and key under the mesh), so
   that after two warm-up calls of a kind (eager, capturing) every call is
   a replay: host-clock ms per call (ending in a synchronize) and the
   kernels' launches per call; then each once more under torch.profiler:
   the device-busy share of the profiled wall time (union of CUDA kernel
   and memcpy intervals), the most CUDA streams busy at once, and the host
   launches (kernel and graph launches, copies, memsets);
2. a ``--frames``-frame chain-on encode through the default preset: frames/s
   and launches, and the same two profiler numbers; after a warm-up encode
   of each, so that the pipelines' sets replay every key.

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
    """(device-busy share of the wall time, the most streams busy at once,
    host launches) of one call of fn under torch.profiler."""
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
    cuda = torch.autograd.DeviceType.CUDA
    host = sum(1 for e in prof.events() if e.device_type != cuda
               and e.name.startswith(chip_smoke.HOST_LAUNCH_CALLS))
    return busy_ms / wall_ms, streams, host


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
    from rav1e_tpu_torch.device import analysis
    from rav1e_tpu_torch.device.graphs import AnalysisPrograms
    from rav1e_tpu_torch.parallel import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.gpu_info(), flush=True)
    clip = chip_smoke.synth_clip(chip_smoke.WIDTH, chip_smoke.HEIGHT,
                                 max(args.frames, 3),
                                 np.random.default_rng(chip_smoke.SEED))
    mesh = make_mesh(args.slots, devices=["cuda:0"] * args.slots)
    qi = chip_smoke.QUANTIZER
    lam = chip_smoke.analysis_lam(qi)
    y = [clip[i][0] for i in range(3)]
    frames = {"key": (y[1], None, None), "inter": (y[1], y[0], None),
              "inter+bwd": (y[1], y[0], y[2])}
    turns = (("unsharded", None), ("mesh", mesh), ("mesh", mesh),
             ("unsharded", None))
    for label, m in turns:
        runner = AnalysisPrograms("cuda")  # one per turn, every kind
        for kind, (cur, ref0, ref1) in frames.items():
            def call(cur=cur, ref0=ref0, ref1=ref1):
                analysis.analyze_finish(analysis.analyze_frame_async(
                    cur, ref0, ref1, qi, lam, 8, device="cuda",
                    programs=runner))

            with chip_smoke.using_mesh(m):
                call()  # warm-up: the key's eager run
                call()  # and its capture
                ms, launches = timed(call, args.reps)
                share, streams, host = profiled(call)
            print(f"analysis {kind:10s} {label:9s} {ms:.3f} ms/call, "
                  f"device busy {share:.4f} of the wall, {streams} "
                  f"streams busy at once, {host} host launches, "
                  f"launches/call {launches}", flush=True)
    sub = clip[:args.frames]
    # warm-up: two contexts of each, so that every key of the clip (its key
    # frame's among them, one frame a context) is captured
    for m in (None, mesh, None, mesh):
        chip_smoke.mesh_encode(r, sub, m)
    for label, m in turns:
        pkts, launches, s, _ = chip_smoke.mesh_encode(r, sub, m)
        share, streams, host = profiled(
            lambda: chip_smoke.mesh_encode(r, sub, m))
        print(f"encode {len(sub)} frames {label:9s} "
              f"{len(sub) / s:.4f} frames/s, launches {launches}, "
              f"device busy {share:.4f} of the wall, {streams} streams "
              f"busy at once, {host} host launches, {len(pkts)} "
              "packets", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
