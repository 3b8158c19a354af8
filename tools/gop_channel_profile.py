#!/usr/bin/env python3
"""Why GOP-parallel slots share one CUDA card the way they do.

    python3 tools/gop_channel_profile.py [--frames 48] [--slots 3]

Encodes chip_smoke.py's 1080p pan (keyframes every 16 frames) through
``Config.new_channel()`` on the card, after a 16-frame warm-up of each
channel: ``--slots`` GOP slots and serial (``parallel_gops=0``) in turns
under the interpreter's default switch interval (5 ms) and under 0.5 ms,
then both with one PyTorch CPU thread, then 2 slots, then the slots once
more with a sampler that reads the worker threads' Python stacks every 5 ms.
Prints each run's frames/s, the process's user and system CPU time against
the wall time, the stage spans that take the most host time per frame, and
the sampled run's most frequent innermost lines: whether the slots wait on
each other or burn CPU, and where.  Prints the card's name and power limit
first.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

SPANS = ("chain_dispatch", "chain_replay_code", "chain_wait_ready",
         "device_analysis", "encode_tiles", "lrf_decide", "cdef_rdo_device")


class StackSampler:
    """Counts the innermost line of every other thread's Python stack, every
    5 ms, while it runs; threads parked in ``threading`` or ``queue`` (the
    channel's splitter and reassembler, idle workers) are left out."""

    def __init__(self):
        self.counts = collections.Counter()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        me, main = threading.get_ident(), threading.main_thread().ident
        while not self._stop.wait(0.005):
            for tid, frame in sys._current_frames().items():
                code = frame.f_code
                if tid not in (me, main) and not code.co_filename.endswith(
                        ("threading.py", "queue.py")):
                    self.counts[(os.path.relpath(code.co_filename),
                                 frame.f_lineno, code.co_name)] += 1

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)


def run(r, slots, clip, interval=0.005, threads=None, sample=False):
    import torch

    from rav1e_tpu_torch.utils import trace

    cfg = chip_smoke.gop_config(r, slots)
    old = sys.getswitchinterval(), torch.get_num_threads()
    sys.setswitchinterval(interval)
    if threads:
        torch.set_num_threads(threads)
    trace.reset()
    sampler = StackSampler() if sample else None
    try:
        torch.cuda.synchronize()
        t, t0 = time.monotonic(), os.times()
        if sampler:
            with sampler:
                chip_smoke.channel_encode(cfg, clip)
        else:
            chip_smoke.channel_encode(cfg, clip)
        torch.cuda.synchronize()
        wall, t1 = time.monotonic() - t, os.times()
    finally:
        sys.setswitchinterval(old[0])
        torch.set_num_threads(old[1])
    spans = trace.stage_summary()
    trace.reset()
    n = len(clip)
    user, system = t1.user - t0.user, t1.system - t0.system
    per_frame = " ".join(
        f"{k}={spans[k]['total_ms'] / n:.1f}" for k in SPANS if k in spans)
    print(f"parallel_gops={slots} switch={interval * 1e3:.1f} ms torch "
          f"threads={threads or old[1]}{' sampled' if sample else ''}: "
          f"{n / wall:.4f} frames/s, wall {wall:.3f} s, user {user:.2f} s, "
          f"system {system:.2f} s ({(user + system) / wall:.2f} cores); "
          f"ms per frame: {per_frame}", flush=True)
    if sampler:
        total = sum(sampler.counts.values())
        for (f, line, fn), k in sampler.counts.most_common(15):
            print(f"  {k / total:6.1%} {f}:{line} {fn}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=chip_smoke.GOP_FRAMES)
    ap.add_argument("--slots", type=int, default=chip_smoke.GOP_SLOTS)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import rav1e_tpu_torch as r
    from rav1e_tpu_torch.utils import trace

    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA card")
    print(chip_smoke.gpu_info(), flush=True)
    trace.trace_enable()
    clip = chip_smoke.synth_clip(chip_smoke.WIDTH, chip_smoke.HEIGHT,
                                 args.frames, np.random.default_rng(
                                     chip_smoke.SEED))
    for slots in (args.slots, 0):  # warm-up: build, cuBLAS, caches
        chip_smoke.channel_encode(chip_smoke.gop_config(r, slots),
                                  clip[: chip_smoke.GOP_LEN])
    for interval in (0.005, 0.0005):
        for slots in (args.slots, 0, 0, args.slots):
            run(r, slots, clip, interval)
    for slots in (args.slots, 0):
        run(r, slots, clip, threads=1)
    run(r, 2, clip)
    run(r, args.slots, clip, sample=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
