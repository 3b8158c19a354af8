#!/usr/bin/env python3
"""Where the time of the PyTorch port's speed-6 slice goes, on one CUDA card.

    python3 tools/torch_slice_profile.py

Encodes chip_smoke.py's synthetic 1080p pan twice through
rav1e_tpu_torch.Config(device="cuda"): once to warm up (kernel build,
cuBLAS, native coder), then under torch.profiler.  Prints the host-clock
frames/s, the pipeline's stage spans, the device's busy and idle share of
the profiled wall time (union of CUDA kernel and memcpy intervals), the
CUDA kernels that took the most device time, and each device stage (the
analysis of a key, an inter and a bidirectional frame; the CDEF stage) run
alone: host-clock and device-busy ms per call.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def _union_us(intervals):
    total = 0.0
    end = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _busy_us(prof):
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return _union_us([(e.time_range.start, e.time_range.end)
                      for e in prof.events() if e.device_type == cuda])


def stage_times(clip, width, height, reps=3):
    """Per call of each device stage alone, after a warm-up: host-clock ms
    (ending in a synchronize) and device-busy ms (profiler)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rav1e_tpu_torch import tables
    from rav1e_tpu_torch.config import ChromaSampling
    from rav1e_tpu_torch.frame import Frame
    from rav1e_tpu_torch.device import analysis, filters

    qi = chip_smoke.QUANTIZER
    q_step = tables.ac_q(qi, 0, 8) / 8.0
    q = torch.tensor(float(tables.ac_q(qi, 0, 8)), device="cuda")
    lam = torch.tensor(0.12 * q_step * q_step, device="cuda")
    y = [analysis.upload_source_luma(clip[i][0], "cuda").to(torch.int32)
         for i in range(3)]

    def frame(planes):
        f = Frame.new(width, height, ChromaSampling.Cs420, 8)
        for p, arr in zip(f.planes, planes):
            p.copy_from(arr)
            p.pad()
        return f

    rec, src = frame(clip[1]), frame(clip[0])

    class Blocks:
        cols = 2 * ((width + 7) >> 3)
        rows = 2 * ((height + 7) >> 3)
        skip = np.zeros((rows, cols), dtype=bool)

    stages = {
        "analysis key": lambda: analysis._frame_analysis(
            y[0], y[0], y[0], y[0], q, lam, 8, False),
        "analysis inter": lambda: analysis._frame_analysis(
            y[1], y[0], y[0], y[0], q, lam, 8, True),
        "analysis inter+bwd": lambda: analysis._frame_analysis(
            y[1], y[0], y[2], y[0], q, lam, 8, True, True),
        "cdef_device_frame (incl. copies)": lambda: filters.cdef_device_frame(
            rec, src, Blocks, 8, ChromaSampling.Cs420, width, height, 3, 9, 5,
            device="cuda"),
    }
    out = {}
    for name, fn in stages.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3 / reps
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out[name] = (wall_ms, _busy_us(prof) / 1e3)
    return out


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import rav1e_tpu_torch
    from rav1e_tpu_torch.utils import trace

    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = chip_smoke.gpu_info()
    rng = np.random.default_rng(chip_smoke.SEED)
    width, height, nframes = (chip_smoke.WIDTH, chip_smoke.HEIGHT,
                              chip_smoke.NFRAMES)
    clip = chip_smoke.synth_clip(width, height, nframes, rng)

    def context():
        return chip_smoke.slice_config(rav1e_tpu_torch, "cuda").new_context()

    warm = context()
    chip_smoke.encode(warm, clip[:4], rav1e_tpu_torch)

    trace.trace_enable()
    trace.reset()
    ctx = context()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        chip_smoke.encode(ctx, clip, rav1e_tpu_torch)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    print(f"card: {info}")
    print(f"{nframes} frames {width}x{height} in {wall:.3f} s "
          f"= {nframes / wall:.4f} frames/s (host clock, under the "
          "profiler)")
    for name, s in trace.stage_summary().items():
        print(f"  span {name:18s} count={s['count']} total_ms={s['total_ms']}"
              f" mean_ms={s['mean_ms']}")

    busy_us = _busy_us(prof)
    print(f"device busy {busy_us / 1e3:.3f} ms of {wall * 1e3:.3f} ms wall: "
          f"busy share {busy_us / 1e6 / wall:.6f}, "
          f"idle share {1 - busy_us / 1e6 / wall:.6f}")
    cuda = torch.autograd.DeviceType.CUDA
    rows = [a for a in prof.key_averages() if a.device_type == cuda]
    rows.sort(key=lambda a: a.self_device_time_total, reverse=True)
    total = sum(a.self_device_time_total for a in rows)
    print(f"CUDA kernel time by name (total {total / 1e3:.3f} ms):")
    for a in rows[:25]:
        print(f"  {a.self_device_time_total / 1e3:10.3f} ms  {a.count:7d}x  "
              f"{a.key[:90]}")
    print("device stages alone, per call (host-clock ms, device-busy ms):")
    for name, (wall_ms, busy_ms) in stage_times(clip, width, height).items():
        print(f"  {name:34s} {wall_ms:10.3f} {busy_ms:10.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
