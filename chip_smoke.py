#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rav1e_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line with its time:

1. environment: a CUDA device is required (no CPU stand-in); TF32 off; the
   card's name and power limit from nvidia-smi;
2. build: the CUDA kernels from rav1e_tpu_torch/csrc with nvcc, and the
   host coder's native library;
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, exactly equal, at the encoder's 1080p shapes plus a ragged
   batch and 12-bit magnitudes, with both timed by CUDA events (a kernel's
   time the median of 5 timings of 20 calls, printed with their spread):
   satd8 at the intra and subpel shapes and at 12-bit diffs whose 64x64
   block sums reach their bound (4096 * 4095), grid_search at the four
   full-pel rounds that me_field runs on two frames of the clip, on a flat
   plane (every key ties within a seed) and at a ragged n = 37; the filter
   stage's kernels (cdef_dirs, cdef_search, cdef_apply, deblock_edges) at
   the nine calls of the chain's stage 4 on a bidirectional 1080p frame of
   the clip, the standalone CDEF stage at 10 and 12 bits, 4:2:2 (with pri 0
   and sec 3 candidates), 4:4:4 and a ragged 200x136 crop, and the luma
   deblock passes at 10 and 12 bits and on the ragged crop; prints each
   route's filter-kernel launches per run (a chain frame's stage 4, a
   standalone CDEF stage);
4. slice: a 16-frame 1080p 8-bit 4:2:0 encode through the default
   rav1e_tpu_torch.Config() at speed 6 (device "cuda"; device analysis and
   device reconstruction chain on, pyramid reordering); prints the frames
   the chain coded, its overflow and replay-divergence fallbacks and its
   predispatch hits; at least one inter frame is chain-coded, and both
   kernels were launched by the encode; prints the pipeline's runs of its
   replayed programs (device/graphs.py: its own eager, capturing and
   replayed runs, and its set's keys, captures, replays and pool bytes,
   over every pipeline that held the set) and fails unless every chain
   frame was a run of the pipeline's set and no key of the set ran
   eagerly or was captured twice, for the chain, analysis and CDEF
   runners alike; every packet decodes to its reconstruction through
   rav1e_tpu_torch.decoder;
5. chain-off tier: the same preset with device_chain=False over the first
   4 frames (every frame through the host tile coder and the standalone
   CDEF stage), with the same launch, graph and decode checks, and each
   CDEF graph replay held against the stage run eagerly on the card on
   the same inputs;
6. chain stages: the five device-chain stages for one bidirectional inter
   frame of the clip, on the card and on the CPU from identical inputs
   (maps, MV fields, packed aux, reference planes): every output exactly
   equal, plus the selection stage on all-zero MV fields, where candidates
   tie; then through a ChainPrograms on the card, a frame of the same key
   (clip frame 3 against 1, 5 and 9) captured and replayed and the first
   frame replayed after it: all 15 stage outputs equal the eager stages'
   after each run, the earlier run's copies are kept, and each run's host
   time to enqueue is printed; each stage timed
   by CUDA events eagerly and as a replay, with its host launches, kernels
   and device-busy time from torch.profiler (stage 4 also with its filter
   kernels' launches, eager and replayed), and one whole dispatch +
   fetch eager and replayed, whose steady state must make fewer than 100
   host launches;
7. analysis: the port's whole-frame analysis on the card against the same
   analysis on the CPU (plain versions) for a key, a forward-inter and a
   bidirectional frame: MV fields exactly equal, and every differing
   decision cell a near-tie (relative cost gap < 1e-5 on the CPU); then
   the analysis as CUDA graphs at each of its four keys (intra, forward,
   +backward, +far backward), eager, capturing and replayed, each exactly
   equal to the eager analysis on the card in all seven outputs and in
   launch counts, two dispatches of a key kept apart, and each timed and
   profiled (a replay must make at most 10 host launches);
8. small clip: a 256x128 6-frame encode (chain on) on the card and on the
   CPU gives byte-identical packets;
9. cli (run right after the slice, its decode check in the decode phase):
   the slice's clip written to a y4m and encoded by
   ``python -m rav1e_tpu_torch.cli`` in a subprocess on the card with the
   slice's settings; the IVF payloads equal the slice's packets byte for
   byte, and the decode phase holds every shown frame against the CLI's
   ``-r`` reconstruction; prints the CLI's frames/s, chain frames and
   kernel launches;
10. gop: 48 frames of 1080p with keyframes every 16 through
   ``Config.new_channel()`` with ``parallel_gops=3`` (a CUDA stream per
   worker): the packets equal, in order, each 16-frame chunk encoded alone
   in a fresh serial context, and decode to their reconstructions (each
   chunk in a process of its own, checked after the configs phase); a
   serial channel over the same frames for the numbers only; each channel
   timed without and then under the profiler, in turns: frames/s, host CPU
   time, and under the profiler the device idle share (its busy time over
   the wall time) and the most CUDA streams busy at once; then more chunks
   than slots: bench.py's clip settings (640x384) over 48 frames with a
   key frame every 8 on 3 slots, whose packets equal each chunk encoded
   alone, through at most 3 sets of runners, no key of a set captured
   twice, and chunks 4-6 running no key eagerly;
11. capi: the port's C shim and example (``rav1e_tpu_torch/capi/``) built
   with g++ and the Python embed flags, run with "cuda" and with "cpu":
   the packet lines must be identical;
12. configs: a 256x128 6-frame clip on the card and on the CPU (in worker
   processes) gives byte-identical packets at reference_cells.py's ten
   configurations (10 and 12 bit, 4:2:2, 4:4:4, 2x2 tiles, low latency,
   speeds 8, 9 and 10, and a ragged clip, here 200x136); then its 4 fuzz
   seeds through ``fuzz_encode_decode`` on the card; prints each
   configuration's chain frames, runs of the replayed programs (no key of
   a set eager or captured twice) and kernel launches;
13. reference: every cell of reference_cells.py, the
   640x384 16-frame bench clip included, encoded on the card with the
   kernels on gives rav1e_tpu's packets byte for byte (their hashes in
   tests/data/torch_reference_packets.json, made by
   tools/torch_reference_packets.py), and every packet decodes to its
   reconstruction; prints per cell the packets, the chain frames, the
   runs of the replayed programs (as in the configs phase) and the kernel
   launches; a differing cell is encoded on the CPU too, to say
   whether the card or the port differs; then the 17 small cells once
   more in reverse order, through the sets of runners the first pass left
   in the process's store (configurations that share keys replay each
   other's graphs): the same packets, spans and launches, no key run
   eagerly, and a capture only of a key the first pass ran once; prints
   the store's sets after each pass;
14. mesh: ``make_mesh(4, devices=["cuda:0"] * 4)``, four slots of the card,
   each band on a stream of its own: sharded_frame_analysis and
   sharded_inter_analysis on a 1024x1920 frame pair equal the same calls
   on 4 CPU slots (maps and MVs exactly, bits within 1e-5 relative); the
   port's dryrun_multichip on the card's slots; the band runners (a CUDA
   graph per slot and key, device/graphs.py ``BandPrograms``) at the four
   1080p analysis keys through a set of the store, eager, capturing and
   replayed, each exactly equal to the eager mesh analysis in all seven
   outputs and in launch counts, two dispatches kept apart, with host ms
   and host launches per analysis and per band replay (at most 10); a
   4-frame 1080p chain-on encode in turns unsharded, mesh, mesh,
   unsharded (the mesh the card's slots): both mesh contexts give the
   unsharded packets, which decode, at 4x its kernel launches, and the
   second runs no band key eagerly and captures none; a 2-slot GOP
   channel under the mesh equals its chunks encoded alone; prints each
   context's frames/s, kernel launches and band runs beside the card's
   name and power limit;
15. bench: ``python3 bench_torch.py`` (bench.py's workload through the
   port on the card) in a subprocess; prints each timed repetition's
   seconds and runs of the replayed programs, of which the second and
   third must run no key eagerly and capture none, and its JSON line;
16. launches: every phase's satd8 and grid_search launches equal those of
   every earlier card run (``LAUNCHES_BY_PHASE``); each phase has already
   held the filter kernels' launches to its runs of each route (chain
   frames x a stage-4 run's launches + CDEF stages x a CDEF run's, the
   runs counted at ``ChainPrograms.run`` and ``CdefPrograms.run``; the
   CLI's equal to the slice's); store: the process's sets of runners and
   their pools' bytes.

The line before the last is the kernels' JSON summary, preceded by
nvidia-smi's name and power limit; the last line is
{"ok": true, "device": {...}}.  Any failure exits non-zero without it.
Each kernel's bound is the larger of its bytes (each input read once, each
output written once) over the H100's 3.35 TB/s and its integer operations
over the card's 32-bit integer rate, its SMs x 64 INT32 lanes x its maximum
SM clock (``nvidia-smi --query-gpu=clocks.max.sm``, printed in the env
phase), computed from this run's inputs (the filter kernels' operations
from the cells, samples and edges this run's data filters).  No one
PyTorch call computes any kernel's function: every ``library_ms`` is null.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

import reference_cells

ROOT = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT, NFRAMES, QUANTIZER = 1920, 1080, 16, 120
GOP_FRAMES, GOP_LEN, GOP_SLOTS = 48, 16, 3
NEAR_TIE = 1e-5
SEED = 42
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# Hopper issues 32-bit integer operations on 64 INT32 lanes per SM; the
# kernels' SAD and Hadamard arithmetic is integer, so their operations
# bound is SMs x 64 x the SM clock (int32_ops_per_s)
INT32_LANES_PER_SM = 64
# satd8, per 8x8 cell: 16 eight-point butterflies of 24 add/sub, 64 |.|,
# 64 adds
SATD_OPS_PER_CELL = 16 * 24 + 64 + 64
# a kernel's time: the median of this many CUDA-event timings of 20 calls
KERNEL_RUNS = 5
# the filter stage's kernels (csrc/cdef.cu, csrc/deblock.cu), whose launches
# each phase's routes give: a chain frame's stage 4 and a standalone CDEF
# stage launch fixed sets of them (ROUTE_LAUNCHES)
FILTER_KERNELS = ("cdef_dirs", "cdef_search", "cdef_apply", "deblock_edges")
# integer operations, counted from the plain versions' formulas: cdef_dirs
# per 8x8 cell (64 samples x shift, offset and 8 bucket adds; 8 x 15
# buckets squared, weighted and summed; the argmax and the variance);
# CDEF per filtered sample (12 taps into the max/min envelopes, rounding
# and the clamp) and per tap of nonzero strength (a constrain(): sub, abs,
# shift, sub, max, min, sign, multiply, add); the SSE per sample (sub,
# multiply, add); deblock per edge line of each filter size (masks, the
# narrow filter, the flatness tests, the wide taps, the deltas)
CDEF_DIRS_OPS_PER_CELL = 64 * 10 + 8 * 15 * 3 + 12
CDEF_SAMPLE_OPS = 12 * 2 + 6
CDEF_TAP_OPS = 9
CDEF_SSE_OPS = 3
DEBLOCK_OPS_PER_LINE = {4: 45, 6: 92, 8: 134, 14: 374}
# (satd8, grid_search) launches of each phase's encode on the card, which
# every card run has given (PERF.md, section 6): a replay counts the
# launches its graph holds, so neither graphs nor their store moves them.
# The mesh phase encodes its 4 frames in two mesh contexts, each 76 and
# 48 (4 slots x the unsharded 19 and 12), the second through band replays
# only: the entry is their sum
LAUNCHES_BY_PHASE = {"slice": (94, 120), "cli": (94, 120),
                     "chain-off": (19, 12), "gop": (282, 360),
                     "mesh": (152, 96), "reference": (433, 340)}


ANALYSIS_KERNELS = ("satd8", "grid_search")
# the first pass's kernels (csrc/firstpass.cu): every encode on the card
# runs the scene detector's two; the lookahead's two run for each pyramid
# group with temporal RDO
FIRSTPASS_KERNELS = ("fp_downsample", "fp_scene_sums", "fp_la_intra",
                     "fp_la_motion")
# integer operations, from the plain versions' formulas: a downsampled
# sample (3 adds, a shift); a compared sample a shift and plane (sub, abs,
# add) and a gradient sample (2 x sub, abs, add); an intra cell sample (row
# and column sums, three scaled residuals: multiply, sub, abs, add); a
# candidate or inter-cost sample (sub, abs, add)
FP_DOWNSAMPLE_OPS = 4
FP_SHIFT_OPS = 3
FP_GRAD_OPS = 6
FP_INTRA_OPS_PER_SAMPLE = 2 + 3 * 4
FP_SAD_OPS = 3
# runs of the two routes through the filter kernels since the last
# reset_counts(): a chain frame (graphs.ChainPrograms.run: stage 4 once)
# and a standalone CDEF stage (graphs.CdefPrograms.run); and each route's
# filter-kernel launches per run, as the kernel phase counts them
ROUTE_RUNS = {"chain": 0, "cdef": 0}
ROUTE_LAUNCHES = {}
_route_lock = threading.Lock()


def count_routes() -> None:
    """Count every run of the two routes, on any thread (wraps the
    runners' ``run``)."""
    from rav1e_tpu_torch.device import graphs

    for cls, name in ((graphs.ChainPrograms, "chain"),
                      (graphs.CdefPrograms, "cdef")):
        def run(self, *a, _real=cls.run, _name=name, **k):
            with _route_lock:
                ROUTE_RUNS[_name] += 1
            return _real(self, *a, **k)

        cls.run = run


def reset_counts() -> None:
    """Set the kernels' launch counts and the routes' runs to 0."""
    from rav1e_tpu_torch.device import kernels

    kernels.reset_launches()
    with _route_lock:
        for k in ROUTE_RUNS:
            ROUTE_RUNS[k] = 0


def filter_launches(runs, extra_cdef=0):
    """The filter kernels' launches that ``runs`` (route -> runs, as
    ROUTE_RUNS) make, with ``extra_cdef`` more CDEF stages."""
    n = {"chain": runs["chain"], "cdef": runs["cdef"] + extra_cdef}
    return {k: sum(n[r] * ROUTE_LAUNCHES[r][k] for r in n)
            for k in FILTER_KERNELS}


def filter_launch_fault(label, launches, runs, extra_cdef=0):
    """A fault unless the filter kernels' launches are those that the
    phase's runs of each route make (a replay counts what its graph
    holds)."""
    want = filter_launches(runs, extra_cdef)
    got = {k: launches.get(k, 0) for k in FILTER_KERNELS}
    if got != want:
        return (f"{label}: filter kernel launches {got}, not the {want} of "
                f"{runs['chain']} chain frames and "
                f"{runs['cdef'] + extra_cdef} CDEF stages")
    return None


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str, t0: float, detail: str = "") -> None:
    print(f"[{name}] {time.monotonic() - t0:.3f} s {detail}".rstrip(),
          flush=True)


def gpu_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over `reps` calls, by CUDA events."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def int32_ops_per_s():
    """(32-bit integer operations per second of card 0, its SM count, its
    maximum SM clock in MHz): the SMs x INT32_LANES_PER_SM x the clock that
    ``nvidia-smi --query-gpu=clocks.max.sm`` reports."""
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    mhz = float(out.stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_LANES_PER_SM * mhz * 1e6, sms, mhz


def bound(nbytes: float, ops: float, ops_per_s: float):
    """(least ms the card could take, what bounds it), at ``ops_per_s``
    integer operations per second."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


def grid_search_rounds(luma, ref, bd=8):
    """The arguments of the four full-pel rounds that me_field runs on these
    (H, W) int32 planes, in order."""
    from rav1e_tpu_torch.device import me

    calls = []
    real = me._grid_search

    def record(*args):
        calls.append(args)
        return real(*args)

    me._grid_search = record
    try:
        me.me_field(luma, ref, bd)
    finally:
        me._grid_search = real
    return calls


def grid_search_bound(args):
    """Bytes and operations of one grid_search call on these inputs: the
    source blocks, the block origins, the seeds, the reference samples that
    the windows cover, each read once; the MVs written once."""
    import torch

    src, ref_pad, by, bx, seeds, blk, R, step, pad_off, clip = args
    W = blk + 2 * R * step
    ar = torch.arange(W, device=ref_pad.device)
    covered = torch.zeros(ref_pad.shape, dtype=torch.bool,
                          device=ref_pad.device)
    for sd in seeds:
        ty = by + sd[:, 0].clamp(-clip, clip) - R * step + pad_off
        tx = bx + sd[:, 1].clamp(-clip, clip) - R * step + pad_off
        covered[(ty[:, None, None] + ar[None, :, None]).long(),
                (tx[:, None, None] + ar[None, None, :]).long()] = True
    n = src.shape[0]
    nbytes = 4 * (src.numel() + by.numel() + bx.numel()
                  + sum(sd.numel() for sd in seeds) + int(covered.sum())
                  + 2 * n)
    ops = 3 * n * len(seeds) * (2 * R + 1) ** 2 * blk * blk
    return nbytes, ops


def satd_bound_diffs(n, m, g):
    """(n, 13, 64, 64) int32 diffs at the bound of satd8's block sum: each
    8x8 cell is +-m * (-1)^popcount(x & y), whose Hadamard transform has all
    64 coefficients of magnitude 8m, so each cell scores 64m and each 64x64
    block 4096m, at 12 bits 16,773,120 < 2^24 (tests/test_torch_kernels.py
    holds the same diffs on the CPU)."""
    import torch

    x = torch.arange(8, device=g.device)
    b = x[:, None] & x[None, :]
    odd = (b ^ (b >> 1) ^ (b >> 2)) & 1
    cell = m * (1 - 2 * odd).to(torch.int32)
    sign = torch.randint(0, 2, (n, 13, 8, 8), generator=g, device=g.device,
                         dtype=torch.int32) * 2 - 1
    d = sign[..., :, None, :, None] * cell[:, None, :]
    return d.reshape(n, 13, 64, 64).contiguous()


def record_filter_calls(fn):
    """fn() with the filter kernels' wrappers recording their arguments:
    (fn's result, [(kernel, wrapper, plain version, args)] in call
    order)."""
    from rav1e_tpu_torch.device import dsp, filters

    wrappers = ((dsp, "deblock_pass_device", "deblock_edges",
                 dsp.deblock_pass_plain),
                (filters, "cdef_dirs", "cdef_dirs", filters.cdef_dirs_plain),
                (filters, "cdef_search", "cdef_search",
                 filters.cdef_search_plain),
                (filters, "cdef_apply", "cdef_apply",
                 filters.cdef_apply_plain))
    calls = []
    reals = [getattr(mod, attr) for mod, attr, _n, _p in wrappers]
    for (mod, attr, name, plain), real in zip(wrappers, reals):
        def record(*a, _real=real, _name=name, _plain=plain):
            calls.append((_name, _real, _plain, a))
            return _real(*a)

        setattr(mod, attr, record)
    try:
        out = fn()
    finally:
        for (mod, attr, _n, _p), real in zip(wrappers, reals):
            setattr(mod, attr, real)
    return out, calls


def cdef_case(clip, w, h, bd, dec, lists, seed, dev):
    """cdef_stage_core's inputs for the top-left w x h of the clip at
    ``bd`` bits and chroma decimation ``dec`` (xdec, ydec): frame 1 as the
    reconstruction (its grids with a 2px ring, edge-replicated where the
    frame ends), frame 2 as the source, chroma decimated from the luma
    planes shifted 37 columns a plane (the clip is 4:2:0), the bits below
    the top 8 random, a random half of the cells skipped, and the strength
    lists ``lists``."""
    import torch

    rng = np.random.default_rng(seed)
    nby, nbx = -(-h // 8), -(-w // 8)
    planes, rec, src = [], [], []
    for pi, (xd, yd) in enumerate([(0, 0), dec, dec]):
        ys, xs = 8 >> yd, 8 >> xd
        planes.append((ys, xs, (h + (1 << yd) - 1) >> yd,
                       (w + (1 << xd) - 1) >> xd))
        grids = []
        for frame, ring in ((clip[1][0], 2), (clip[2][0], 0)):
            a = np.roll(frame, 37 * pi, axis=1)[:: 1 << yd, :: 1 << xd]
            a = np.pad(a, ((ring, 8 + ring), (ring, 8 + ring)), mode="edge")[
                : nby * ys + 2 * ring, : nbx * xs + 2 * ring].astype(np.int32)
            a = (a << (bd - 8)) | rng.integers(0, 1 << (bd - 8), a.shape,
                                               dtype=np.int32)
            grids.append(torch.from_numpy(a).to(dev))
        rec.append(grids[0])
        src.append(grids[1])
    filt = torch.from_numpy(rng.random((nby, nbx)) >= 0.5).to(dev)
    grid = (nby, nbx, -(-h // 64), -(-w // 64), w, h)
    return (planes, grid, 3, bd, rec, src, filt, list(lists[0]),
            list(lists[1]))


def _cdef_sample_ops(planes, grid, filt, cands, y_str, uv_str, sse):
    """Integer operations of filtering the visible samples of ``filt``'s
    cells at candidate ``cands`` (an int, or a per-cell tensor), plus the
    SSE's when ``sse``."""
    import torch

    nby, nbx = grid[0], grid[1]
    dev = filt.device
    ops = 0
    for pi, (ys, xs, vh, vw) in enumerate(planes):
        rows = (vh - torch.arange(nby, device=dev) * ys).clamp(0, ys)
        cols = (vw - torch.arange(nbx, device=dev) * xs).clamp(0, xs)
        per_cell = rows[:, None] * cols[None, :] * filt
        strs = y_str if pi == 0 else uv_str
        taps = torch.tensor([(4 if v // 4 else 0) + (8 if v % 4 else 0)
                             for v in strs], device=dev)
        per_sample = (CDEF_SAMPLE_OPS + CDEF_TAP_OPS * taps[cands]
                      + (CDEF_SSE_OPS if sse else 0))
        ops += int((per_cell * per_sample).sum())
    return ops


def filter_bound(name, args, out):
    """Bytes and integer operations of one filter-kernel call on these
    inputs, with ``out`` its output: each input read once, each output
    written once, and the operations this call's data needs (filtered
    cells and samples, edges of nonzero size)."""
    import torch

    if name == "deblock_edges":
        rec, fs = args[0], args[1]
        ops = sum(4 * DEBLOCK_OPS_PER_LINE[k] * int((fs == k).sum())
                  for k in DEBLOCK_OPS_PER_LINE)
        return 4 * (2 * rec.numel() + fs.numel() + 1), ops
    if name == "cdef_dirs":
        luma, nby, nbx = args[:3]
        return (4 * luma.numel() + 8 * nby * nbx,
                CDEF_DIRS_OPS_PER_CELL * nby * nbx)
    planes, grid = args[0], args[1]
    cells = grid[0] * grid[1]
    rec = args[4]
    nbytes = 4 * sum(g.numel() for g in rec) + 9 * cells
    if name == "cdef_search":
        src, filt, y_str, uv_str = args[5], args[6], args[9], args[10]
        nbytes += 4 * sum(g.numel() for g in src) + 8 * len(y_str) * cells
        ops = sum(_cdef_sample_ops(planes, grid, filt, ci, y_str, uv_str,
                                   True) for ci in range(len(y_str)))
        return nbytes, ops
    filt, sse, y_str, uv_str = args[5], args[8], args[9], args[10]
    idx = out[1]
    sb_rows, sb_cols = grid[2], grid[3]
    by = (torch.arange(grid[0], device=filt.device) // 8).clamp(
        max=sb_rows - 1)
    bx = (torch.arange(grid[1], device=filt.device) // 8).clamp(
        max=sb_cols - 1)
    chosen = idx[by][:, bx]
    nbytes += (sse.numel() * 8 + 8 * idx.numel()
               + 8 * sum(ys * xs * cells for ys, xs, _h, _w in planes))
    return nbytes, sse.numel() + _cdef_sample_ops(
        planes, grid, filt, chosen, y_str, uv_str, False)


def filter_cases(clip, dev):
    """The filter kernels' calls of the kernel phase, as (label, kernel,
    wrapper, plain version, args): the nine of the chain's stage 4 on a
    1080p bidirectional frame of the clip (ChainPrograms' route), the
    standalone CDEF stage at 10 and 12 bits, 4:2:2 (with pri 0 and sec 3
    candidates), 4:4:4 and a ragged 200x136 crop, and the luma deblock
    passes at 10 and 12 bits and on the ragged crop.  Also returns the
    kernels' launches of one stage-4 run and of one CDEF stage run (the
    routes' ROUTE_LAUNCHES)."""
    import torch

    from rav1e_tpu_torch.device import dsp, kernels
    from rav1e_tpu_torch.device.filters import (_strength_lists,
                                                cdef_stage_core)

    _d, calls = chain_calls(chain_case(clip, dev), dev)
    stage4 = calls[3][1]
    with kernels.counting_capture() as per_chain:
        _out, rec = record_filter_calls(stage4)
    cases = []
    planes = iter(("Y", "Y", "U", "U", "V", "V"))
    for name, fn, plain, args in rec:
        label = "1080p chain"
        if name == "deblock_edges":
            how = "vertical" if args[4] else "horizontal"
            label += f" {next(planes)} {how}"
        cases.append((label, name, fn, plain, args))
    deblock_y = [a for _l, n, _f, _p, a in cases if n == "deblock_edges"][:2]
    per_cdef = None
    for label, w, h, bd, dec, lists in (
            ("10-bit 4:2:0 1080p", WIDTH, HEIGHT, 10, (1, 1),
             _strength_lists(9, 5)),
            ("12-bit 4:4:4 1080p", WIDTH, HEIGHT, 12, (0, 0),
             _strength_lists(62, 31)),
            ("8-bit 4:2:2 1080p, pri 0, sec 3", WIDTH, HEIGHT, 8, (1, 0),
             ([0, 3, 7, 63], [3, 0, 1, 60])),
            ("ragged 200x136", 200, 136, 8, (1, 1), _strength_lists(9, 5))):
        args = cdef_case(clip, w, h, bd, dec, lists, SEED + bd, dev)
        with kernels.counting_capture() as tally:
            _out, rec = record_filter_calls(lambda: cdef_stage_core(*args))
        per_cdef = per_cdef or dict(tally)
        cases += [(label, name, fn, plain, a) for name, fn, plain, a in rec]
    g = torch.Generator(device=dev).manual_seed(SEED)
    for rec_p, fs, level, _bd, vertical in deblock_y:
        how = "vertical" if vertical else "horizontal"
        for bd in (10, 12):
            low = torch.randint(0, 1 << (bd - 8), rec_p.shape, generator=g,
                                device=dev, dtype=torch.int32)
            cases.append((f"{bd}-bit 1080p Y {how}", "deblock_edges",
                          dsp.deblock_pass_device, dsp.deblock_pass_plain,
                          ((rec_p << (bd - 8)) | low, fs, level, bd,
                           vertical)))
        cases.append((f"ragged 200x136 Y {how}", "deblock_edges",
                      dsp.deblock_pass_device, dsp.deblock_pass_plain,
                      (rec_p[: 4 * 34 + 16, : 4 * 50 + 16].contiguous(),
                       fs[:34, :50].contiguous(), level, 8, vertical)))
    return cases, dict(per_chain), per_cdef


def firstpass_cases(clip, dev):
    """The first pass's kernel calls of the kernel phase, as (label, kernel,
    wrapper, plain version, args, (bytes, integer operations)): a 1080p
    frame of the clip at 8 bits and widened to 10, as scene detection and
    a lookahead group call them, and a flat plane, where every candidate of
    the motion search ties."""
    import torch

    from rav1e_tpu_torch.device import firstpass as fp

    lumas = [torch.from_numpy(np.ascontiguousarray(clip[i][0])).to(dev)
             for i in range(3)]
    ten = [y.to(torch.int16) * 4 + (y & 3).to(torch.int16) for y in lumas]
    h, w = lumas[0].shape
    ds8 = [fp.downsample(y) for y in lumas]
    ds10 = [fp.downsample(y) for y in ten]
    h2, w2 = ds8[0].shape
    r = fp.shift_radius(h2, w2)
    ns = (2 * r + 1) ** 2
    flat = torch.full_like(lumas[0], 97)
    cases = []
    for bits, y in ((8, lumas[2]), (10, ten[2])):
        cases.append((f"1080p {bits}-bit", "fp_downsample", fp.downsample,
                      fp.downsample_plain, (y,),
                      (h * w * y.element_size() + h2 * w2 * 2,
                       FP_DOWNSAMPLE_OPS * h2 * w2)))
    for label, ds, prev2, grads in (
            ("960x540 r3 2 planes, gradients", ds8, True, True),
            ("960x540 r3 1 plane", ds8, False, False),
            ("10-bit 960x540 r3 2 planes", ds10, True, True)):
        nref = 2 if prev2 else 1
        cases.append((label, "fp_scene_sums", fp.scene_sums,
                      fp.scene_sums_plain,
                      (ds[2], ds[1], ds[0] if prev2 else None, r, grads),
                      ((nref + 1) * h2 * w2 * 2 + 8 * (2 + 2 * ns),
                       FP_SHIFT_OPS * ns * nref * h2 * w2
                       + (FP_GRAD_OPS * h2 * w2 if grads else 0))))
    cells = (h // 8) * (w // 8)
    for bits, y in ((8, lumas[0]), (10, ten[0])):
        cases.append((f"1080p {bits}-bit", "fp_la_intra", fp.la_intra,
                      fp.la_intra_plain, (y, bits),
                      (h * w * y.element_size() + 8 * cells,
                       FP_INTRA_OPS_PER_SAMPLE * 64 * cells)))
    (mby, mbx), (nby, nbx) = fp.motion_shapes(h, w)
    for label, src, ref, bits in (("1080p 8-bit", lumas[1], lumas[0], 8),
                                  ("1080p 10-bit", ten[1], ten[0], 10),
                                  ("1080p flat", flat, flat, 8)):
        stats = {}
        fp.la_motion_plain(src, ref, bits, stats=stats)
        cases.append((label, "fp_la_motion", fp.la_motion,
                      fp.la_motion_plain, (src, ref, bits),
                      (2 * h * w * src.element_size() + 8 * mby * mbx
                       + 8 * nby * nbx,
                       FP_SAD_OPS * 256 * stats["sads"]
                       + FP_SAD_OPS * 64 * nby * nbx)))
    return cases


def _same(got, want):
    """Max abs difference of two outputs (tensors or sequences of them),
    inf where their shapes or dtypes differ."""
    import torch

    a = list(got) if isinstance(got, (tuple, list)) else [got]
    b = list(want) if isinstance(want, (tuple, list)) else [want]
    if len(a) != len(b):
        return float("inf")
    err = 0.0
    for x, y in zip(a, b):
        if isinstance(x, (tuple, list)):
            err = max(err, _same(x, y))
        elif x.shape != y.shape or x.dtype != y.dtype:
            return float("inf")
        elif x.numel():
            err = max(err, float((x.to(torch.float64)
                                  - y.to(torch.float64)).abs().max()))
    return err


def kernel_phase(dev, clip, ops_per_s):
    """Each kernel against its plain version on the card at the main path's
    shapes, timed beside its bound.  Returns the JSON line's numbers per
    kernel and the filter kernels' launches per run of each route."""
    import torch

    from rav1e_tpu_torch.device import kernels
    from rav1e_tpu_torch.device.analysis import upload_source_luma

    g = torch.Generator(device=dev).manual_seed(SEED)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    # satd8 cases: the analysis's intra scoring at 1080p (64-padded to
    # 1088x1920: n blocks x 13 modes per size), the subpel grid (8160 ME
    # blocks x 49 offsets), a ragged batch and 12-bit diffs
    satd_cases = []
    for s in (8, 16, 32, 64):
        n = (1088 // s) * (1920 // s)
        satd_cases.append((f"intra {n}x13x{s}x{s}", (n, 13, s, s), 255))
    satd_cases += [
        ("subpel 8160x49x16x16", (8160, 49, 16, 16), 255),
        ("ragged 37x13x32x32", (37, 13, 32, 32), 255),
        ("12-bit 4097x8x8", (4097, 8, 8), 4095),
        ("12-bit 1031x16x16", (1031, 16, 16), 4095),
        ("12-bit bound 510x13x64x64", (510, 13, 64, 64), None),
    ]
    # grid_search cases: me_field's four rounds on two frames of the clip
    # (1080p, 64-padded to 1088x1920), the same rounds on a flat plane with
    # random seeds (every key ties within a seed), 12-bit samples at L0, and
    # a ragged n = 37
    cur = upload_source_luma(clip[1][0], dev).to(torch.int32)
    ref = upload_source_luma(clip[0][0], dev).to(torch.int32)
    rounds = grid_search_rounds(cur, ref)
    names = ["L2 R3 s2", "L2 R1 s1", "L1 R2 s1", "L0 R2 s1"]
    grid_cases = [(f"{nm} n{a[0].shape[0]}", a)
                  for nm, a in zip(names, rounds)]
    flat = torch.full_like(cur, 97)
    for nm, a in zip(names, grid_search_rounds(flat, flat)):
        clip_mv = a[9]
        seeds = [ints(-2 * clip_mv, 2 * clip_mv + 1, tuple(sd.shape))
                 for sd in a[4]]
        grid_cases.append((f"flat {nm}", (*a[:4], seeds, *a[5:])))
    l0 = rounds[3]
    grid_cases.append(("12-bit L0 R2 s1", (
        ints(0, 4096, tuple(l0[0].shape)), ints(0, 4096, tuple(l0[1].shape)),
        *l0[2:])))
    for nm, a in (("L2 R3 s2", rounds[0]), ("L0 R2 s1", l0)):
        grid_cases.append((f"ragged {nm} n37", (
            a[0][:37], a[1], a[2][:37], a[3][:37], [sd[:37] for sd in a[4]],
            *a[5:])))

    rows = []
    for label, shape, mag in satd_cases:
        d = (ints(-mag, mag + 1, shape) if mag is not None
             else satd_bound_diffs(shape[0], 4095, g))
        got = kernels.satd8(d)
        want = kernels.satd8_plain(d)
        torch.cuda.synchronize()
        err = (float((got - want).abs().max()) if got.shape == want.shape
               else float("inf"))
        if err != 0:
            fail(f"satd8 {label}: kernel != plain (max abs err {err})")
        if mag is None and not bool((got == 4096 * 4095).all()):
            fail(f"satd8 {label}: a block is not at the bound 4096 * 4095")
        runs = [cuda_ms(lambda: kernels.satd8(d), 20)
                for _ in range(KERNEL_RUNS)]
        pms = cuda_ms(lambda: kernels.satd8_plain(d), 5)
        cells = d.numel() // 64
        b = bound(4 * (d.numel() + got.numel()), SATD_OPS_PER_CELL * cells,
                  ops_per_s)
        rows.append(("satd8", label, err, runs, pms, *b))
    for label, a in grid_cases:
        got = kernels.grid_search(*a)
        want = kernels.grid_search_plain(*a)
        torch.cuda.synchronize()
        err = (int((got - want).abs().max()) if got.shape == want.shape
               else float("inf"))
        if err != 0:
            fail(f"grid_search {label}: kernel != plain (max abs err {err})")
        runs = [cuda_ms(lambda: kernels.grid_search(*a), 20)
                for _ in range(KERNEL_RUNS)]
        pms = cuda_ms(lambda: kernels.grid_search_plain(*a), 5)
        rows.append(("grid_search", label, err, runs, pms,
                     *bound(*grid_search_bound(a), ops_per_s)))
    cases, per_chain, per_cdef = filter_cases(clip, dev)
    for label, name, fn, plain, a in cases:
        got = fn(*a)
        want = plain(*a)
        torch.cuda.synchronize()
        err = _same(got, want)
        if err != 0:
            fail(f"{name} {label}: kernel != plain (max abs err {err})")
        runs = [cuda_ms(lambda: fn(*a), 20) for _ in range(KERNEL_RUNS)]
        pms = cuda_ms(lambda: plain(*a), 5)
        rows.append((name, label, err, runs, pms,
                     *bound(*filter_bound(name, a, got), ops_per_s)))
    for label, name, fn, plain, a, (nbytes, ops) in firstpass_cases(clip,
                                                                    dev):
        got = fn(*a)
        want = plain(*a)
        torch.cuda.synchronize()
        err = _same(got, want)
        if err != 0:
            fail(f"{name} {label}: kernel != plain (max abs err {err})")
        runs = [cuda_ms(lambda: fn(*a), 20) for _ in range(KERNEL_RUNS)]
        pms = cuda_ms(lambda: plain(*a), 5)
        rows.append((name, label, err, runs, pms,
                     *bound(nbytes, ops, ops_per_s)))
    summary = {}
    for i, (name, label, err, runs, pms, bms, by) in enumerate(rows):
        ms = float(np.median(runs))
        rows[i] = (name, label, err, ms, pms, bms, by)
        print(f"  {name:13s} {label:32s} max_abs_err={err} kernel_ms={ms:.4f} "
              f"(median of {len(runs)}, {min(runs):.4f}-{max(runs):.4f}) "
              f"plain_ms={pms:.4f} bound_ms={bms:.4f} ({by}) "
              f"share_of_bound={bms / ms:.3f}", flush=True)
        s = summary.setdefault(name, {"max_abs_err": 0.0})
        s["max_abs_err"] = max(s["max_abs_err"], float(err))
    # the JSON line's times: the largest main-path call of each kernel
    for name, label in (("satd8", "subpel 8160x49x16x16"),
                        ("grid_search", grid_cases[3][0]),
                        *((k, "1080p chain") for k in FILTER_KERNELS[:3]),
                        ("deblock_edges", "1080p chain Y vertical"),
                        ("fp_downsample", "1080p 8-bit"),
                        ("fp_scene_sums", "960x540 r3 2 planes, gradients"),
                        ("fp_la_intra", "1080p 8-bit"),
                        ("fp_la_motion", "1080p 8-bit")):
        r = next(r for r in rows if r[0] == name and r[1] == label)
        summary[name].update(ms=r[3], plain_ms=r[4], bound_ms=r[5],
                             bound_by=r[6], shape=label)
    routes = {"chain": {k: per_chain[k] for k in FILTER_KERNELS},
              "cdef": {k: per_cdef[k] for k in FILTER_KERNELS}}
    print(f"  filter kernels' launches per run: stage 4 of a chain frame "
          f"{routes['chain']}, a standalone CDEF stage {routes['cdef']}",
          flush=True)
    return summary, routes


# ---------------------------------------------------------------------------
# phase 4: the slice
# ---------------------------------------------------------------------------


def synth_clip(w, h, n, rng, xdec=1, ydec=1, bd=8):
    """bench.py's seeded synthetic pan (reference_cells.pan_runs): per frame
    its planes, uint8 (uint16 scaled to ``bd`` above 8 bits), chroma
    decimated by ``xdec``/``ydec``."""
    return reference_cells.pan_runs(w, h, [n], rng, xdec, ydec, bd)[0]


def slice_config(rav1e_tpu_torch, device=None, width=WIDTH, height=HEIGHT,
                 chain=True):
    """The slice's Config: the default speed-6 preset (device chain on
    unless ``chain`` is false); no device means the port's default, the
    card."""
    ss = rav1e_tpu_torch.SpeedSettings.from_preset(6)
    ss.device_chain = chain
    kw = {} if device is None else {"device": device}
    return rav1e_tpu_torch.Config(
        enc=rav1e_tpu_torch.EncoderConfig(
            width=width, height=height, quantizer=QUANTIZER,
            low_latency=False, speed_settings=ss,
            min_key_frame_interval=0, max_key_frame_interval=9999,
        ),
        **kw,
    )


def encode(ctx, clip, rav1e_tpu_torch):
    for planes in clip:
        f = ctx.new_frame()
        for p, arr in zip(f.planes, planes):
            p.copy_from(arr)
        ctx.send_frame(f)
    ctx.flush()
    pkts = []
    while True:
        try:
            pkts.append(ctx.receive_packet())
        except rav1e_tpu_torch.EncoderStatus.LimitReached:
            return pkts


def decode_mismatch(pkts, shown=None):
    """Decode (data, rec planes or None, show_frame) triples in order
    through rav1e_tpu_torch.decoder; returns the first mismatch with a
    packet's reconstruction, or with the next of the ``shown`` frames (the
    planes a y4m reconstruction holds) for a shown packet, else None."""
    from rav1e_tpu_torch.decoder import decode_packet

    state = None
    k = 0
    for i, (data, rec, show) in enumerate(pkts):
        dec, state = decode_packet(data, state)
        if rec is None:
            continue
        for pi, dp in enumerate(dec.planes):
            a = dp.as_array()
            if not np.array_equal(a, rec[pi][: a.shape[0], : a.shape[1]]):
                return f"packet {i} plane {pi} does not decode to its rec"
        if shown is not None and show:
            if k >= len(shown):
                return f"packet {i}: more shown frames than {len(shown)}"
            for pi, want in enumerate(shown[k]):
                a = dec.planes[pi].as_array()
                if not np.array_equal(a[: want.shape[0], : want.shape[1]],
                                      want):
                    return (f"packet {i} plane {pi} differs from shown "
                            f"frame {k}")
            k += 1
    if shown is not None and k != len(shown):
        return f"{k} shown packets for {len(shown)} shown frames"
    return None


def decode_triples(pkts):
    return [(p.data, None if p.rec is None
             else [pl.as_array() for pl in p.rec.planes], p.show_frame)
            for p in pkts]


def verify_decode(pkts, shown=None):
    err = decode_mismatch(decode_triples(pkts), shown)
    if err:
        fail(err)


def check_cdef_replays(programs):
    """Hold each replay of ``programs`` (a pipeline's CdefPrograms) against
    ``cdef_stage_core`` run eagerly on the card on the same static inputs,
    planes and index map exactly; returns the list that collects each
    replay's verdict and the list of each run's kind (eager, capture or
    replay) and host ms to enqueue."""
    import torch

    from rav1e_tpu_torch.device.filters import cdef_stage_core

    real = programs.run
    verdicts, runs = [], []

    def run(planes, grid, damping, bd, rec, src, filt, y_str, uv_str):
        key = (tuple(planes), tuple(grid), damping, bd, tuple(y_str),
               tuple(uv_str))
        k = programs._keys.get(key)
        kind = ("eager" if k is None or not k.eager
                else "capture" if k.graphs is None else "replay")
        t0 = time.perf_counter()
        outs, idx = real(planes, grid, damping, bd, rec, src, filt, y_str,
                         uv_str)
        runs.append((kind, (time.perf_counter() - t0) * 1e3))
        if kind != "eager":
            d = programs._keys[key].data
            want, want_idx = cdef_stage_core(
                planes, grid, damping, bd, d["rec"], d["src"], d["filt"],
                list(y_str), list(uv_str))
            verdicts.append(torch.equal(idx, want_idx) and all(
                torch.equal(a, b) for a, b in zip(outs, want)))
        return outs, idx

    programs.run = run
    return verdicts, runs


def encode_phase(rav1e_tpu_torch, clip, chain, label):
    """Encode ``clip`` through the preset on the card with the kernels'
    launch counts set to 0 just before and read just after; returns the
    packets, the launch counts, the stage spans and the pipeline's runs of
    its replayed programs (``FramePipeline.program_stats``), which must
    show every chain frame after its key's first in its set replayed, as
    the analysis and CDEF runs must show every run after its key's first
    (:func:`graph_counts`).  With the chain off each CDEF replay is held
    against the eager stage (:func:`check_cdef_replays`)."""
    import torch

    from rav1e_tpu_torch.device import kernels
    from rav1e_tpu_torch.utils import trace

    trace.trace_enable()
    trace.reset()
    ctx = slice_config(rav1e_tpu_torch, chain=chain).new_context()
    cdef_check = (None if chain
                  else check_cdef_replays(ctx.pipeline._cdef_programs))
    torch.cuda.synchronize()
    reset_counts()
    t = time.monotonic()
    pkts = encode(ctx, clip, rav1e_tpu_torch)
    torch.cuda.synchronize()
    enc_s = time.monotonic() - t
    launches = dict(kernels.LAUNCHES)
    runs = dict(ROUTE_RUNS)
    spans = trace.stage_summary()
    trace.reset()
    if cdef_check is not None:
        # the set goes on to later pipelines without the check
        del ctx.pipeline._cdef_programs.run
    n = len(clip)
    phase(label, t, f"{len(pkts)} packets, {n} frames in {enc_s:.3f} s = "
          f"{n / enc_s:.4f} frames/s at {WIDTH}x{HEIGHT}; launches {launches}")
    for name, s in spans.items():
        print(f"  span {name:22s} count={s['count']} total_ms={s['total_ms']}"
              f" mean_ms={s['mean_ms']}", flush=True)
    coded = sum(1 for p in pkts if p.rec is not None and len(p.data) > 8)
    if coded < 1 or len(pkts) < n:
        fail(f"{label}: {len(pkts)} packets for {n} frames")
    # the chain-on path runs every kernel; the chain-off path no deblock
    # pass (the host deblocks) and, besides the encode's, an eager CDEF
    # stage per checked replay
    # and the first pass's scene kernels every frame, its lookahead kernels
    # for each pyramid group (none in the chain-off tier's 4 frames)
    path = ((*ANALYSIS_KERNELS, *FILTER_KERNELS, *FIRSTPASS_KERNELS) if chain
            else (*ANALYSIS_KERNELS, *FILTER_KERNELS[:3],
                  *FIRSTPASS_KERNELS[:2]))
    for name in path:
        if launches[name] <= 0:
            fail(f"{label}: kernel {name} was not launched by the encode")
    extra = 0 if cdef_check is None else len(cdef_check[0])
    err = filter_launch_fault(label, launches, runs, extra)
    if err:
        fail(err)
    print(f"  routes: {runs['chain']} chain frames, {runs['cdef']} CDEF "
          f"stages (+{extra} eager, checking replays): filter kernel "
          f"launches {filter_launches(runs, extra)}", flush=True)
    if ctx.pipeline.device.type != "cuda":
        fail(f"{label}: the default Config ran on {ctx.pipeline.device}, "
             "not the card")
    frames = span_count(spans, "chain_dispatch")
    report, err = graph_counts(ctx, frames, exact=True)
    print(f"  {frames} chain frames; {report}", flush=True)
    for name, st in ctx.pipeline.program_stats().items():
        for *key, eager, replays in st["set"]["by_key"]:
            print(f"    {name} key {tuple(key)}: {eager} eager, {replays} "
                  "replayed in its set", flush=True)
    if err:
        fail(f"{label}: {err}")
    if cdef_check is not None:
        verdicts, runs = cdef_check
        if not verdicts or not all(verdicts):
            fail(f"{label}: CDEF graph replays against the eager stage: "
                 f"{verdicts}")
        print(f"  {len(verdicts)} CDEF graph replays == the eager stage; "
              "host ms to enqueue (loads from pinned memory included): "
              + ", ".join(f"{kind} {ms:.3f}" for kind, ms in runs),
              flush=True)
    return pkts, launches, spans, ctx.pipeline.program_stats()


def span_count(spans, name):
    return spans[name]["count"] if name in spans else 0


def set_fault(name, st):
    """A fault of a runner's stats over every pipeline that held its set:
    on the card each key runs eagerly once and is captured at most once."""
    if st["eager"] != st["keys"] or st["captures"] != st["captured"]:
        return f"{name} set {st}: a key ran eagerly or was captured twice"
    return None


def graph_counts(ctx, chain_frames, exact=False):
    """The pipeline's runs of its replayed programs (its own eager,
    capturing and replayed runs, and its sets' totals) as a short report,
    and a fault: a key of a set that ran eagerly or was captured twice, or
    fewer chain runs (``exact``: other than) than the ``chain_frames`` the
    pipeline dispatched or coded by the chain."""
    stats = ctx.pipeline.program_stats()
    parts = []
    for name, st in stats.items():
        s = st["set"]
        parts.append(
            f"{name}: {st['eager']} eager, {st['captures']} capturing, "
            f"{st['replays']} replayed (set: {s['keys']} keys, "
            f"{s['captured']} captured, {s['replays']} replayed, pool "
            f"{s['pool_bytes']} bytes)")
    report = "; ".join(parts) or "no device run"
    for name, st in stats.items():
        err = set_fault(name, st["set"])
        if err:
            return report, err
    runs = (stats["chain"]["eager"] + stats["chain"]["replays"] if stats
            else 0)
    if (runs != chain_frames) if exact else (runs < chain_frames):
        return report, (f"{runs} chain runs for {chain_frames} chain frames:"
                        " a chain frame after its key's first was not a "
                        "replay")
    return report, None


# ---------------------------------------------------------------------------
# phase 6: the device-chain stages, card against CPU
# ---------------------------------------------------------------------------

CHAIN_FRAMES = (2, 0, 4, 8)  # the coded frame, then its LAST, ALTREF, BWDREF
# a second frame of the same key (geometry and CDEF lists), for the graphs
CHAIN_FRAMES_B = (3, 1, 5, 9)


def chain_case(clip, dev, frames_at=CHAIN_FRAMES):
    """Inputs of one bidirectional inter frame for the chain stages: clip
    frame 2 against frames 0, 4 and 8 as its three references (or the
    frames ``frames_at`` names), with the card's analysis maps at
    QUANTIZER, no segmentation, and the pipeline's deblock levels and CDEF
    candidate lists.  All host numpy, so both devices get the same
    inputs."""
    from rav1e_tpu_torch import tables
    from rav1e_tpu_torch.config import ChromaSampling
    from rav1e_tpu_torch.device import analysis, chain
    from rav1e_tpu_torch.device.filters import _strength_lists
    from rav1e_tpu_torch.frame import Frame
    from rav1e_tpu_torch.ops.cdef import cdef_strengths_fast
    from rav1e_tpu_torch.ops.deblock import deblock_levels_fast
    from rav1e_tpu_torch.quantize import chroma_q_deltas

    qi, bd = QUANTIZER, 8
    frames = []
    for i in frames_at:
        f = Frame.new(WIDTH, HEIGHT, ChromaSampling.Cs420, bd)
        for p, arr in zip(f.planes, clip[i]):
            p.copy_from(arr)
            p.pad()
        frames.append(f)
    q_step = tables.ac_q(qi, 0, bd) / 8.0
    luma = [clip[i][0] for i in frames_at]
    maps = analysis.analyze_frame(luma[0], luma[1], luma[2], qi,
                                  0.12 * q_step * q_step, bd,
                                  ref2_np=luma[3], device=dev)
    mi_cols, mi_rows = 2 * ((WIDTH + 7) >> 3), 2 * ((HEIGHT + 7) >> 3)
    geom = chain.geom_for(WIDTH, HEIGHT, mi_cols, mi_rows, bd, False, True,
                          True, 3, 6)
    plan = chain.build_plan(maps.size_log2, mi_cols, mi_rows, 3, 6, False)
    fields = chain.clamp_fields(maps, geom.gh // 16, geom.gw // 16)
    dc_d, ac_d = chroma_q_deltas(qi, bd, ChromaSampling.Cs420)
    n8 = (geom.gh // 8, geom.gw // 8)
    dcq8 = np.stack([np.full(n8, tables.dc_q(qi, dc_d[p], bd), np.int32)
                     for p in range(3)])
    acq8 = np.stack([np.full(n8, tables.ac_q(qi, ac_d[p], bd), np.int32)
                     for p in range(3)])
    dbl = deblock_levels_fast(qi, bd, False, tables.ac_q(qi, 0, bd))
    y_list, uv_list = _strength_lists(
        *cdef_strengths_fast(tables.ac_q(qi, 0, bd) >> (bd - 8)))
    return {
        "geom": geom, "plan": plan, "y_list": y_list, "uv_list": uv_list,
        "fields": fields, "dcq8": dcq8, "acq8": acq8, "dbl": dbl,
        "aux": chain.pack_aux(geom, plan, fields, dcq8, acq8, dbl, y_list,
                              uv_list),
        "src": chain.host_src_planes(frames[0], WIDTH, HEIGHT),
        "refs": [chain.host_pad_planes(f, WIDTH, HEIGHT) for f in frames[1:]],
    }


def _device_refs(case, dev):
    import torch

    return tuple(tuple(torch.from_numpy(p).to(dev) for p in r)
                 for r in case["refs"])


STAGE_NAMES = ("select+luma MC", "chroma MC", "tx+quant+recon",
               "deblock+CDEF", "pack")


def chain_calls(case, dev, aux=None):
    """The five stages (``chain.stage_calls``) run once on ``dev``: the dict
    of their inputs and outputs by name, and the stages as (name, call,
    output names), each call reading that dict."""
    import torch

    from rav1e_tpu_torch.device import chain

    d = {"aux": torch.from_numpy(case["aux"] if aux is None else aux).to(dev),
         "src": tuple(torch.from_numpy(p).to(dev) for p in case["src"]),
         "refs": _device_refs(case, dev)}
    calls = [(name, lambda c=c: c(d), names) for name, (names, c) in zip(
        STAGE_NAMES, chain.stage_calls(case["geom"], case["y_list"],
                                       case["uv_list"]))]
    for _name, call, names in calls:
        d.update(zip(names, call()))
    return d, calls


def _flat(v):
    return list(v) if isinstance(v, (tuple, list)) else [v]


def chain_equal(got, want, keys):
    """Names of the outputs that differ between two chain runs."""
    import torch

    bad = []
    for k in keys:
        a, b = _flat(got[k]), _flat(want[k])
        if len(a) != len(b) or not all(
                torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b)):
            bad.append(k)
    return bad


# CUDA runtime and driver calls that enqueue work on the card
HOST_LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch",
                     "cuGraphLaunch", "cudaMemcpy", "cuMemcpy", "cudaMemset",
                     "cuMemset")


def profile_call(call):
    """(device kernels, device copies and memsets, host launches, device-busy
    ms) of one call.  Host launches count the runtime calls that enqueue
    work (kernel and graph launches, copies, memsets); a graph replay is one
    host launch however many kernels it runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    evs = [e for e in prof.events() if e.device_type == cuda]
    host = sum(1 for e in prof.events() if e.device_type != cuda
               and e.name.startswith(HOST_LAUNCH_CALLS))
    copies = sum(1 for e in evs if e.name.startswith(("Memcpy", "Memset")))
    busy, end = 0.0, None
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in evs):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return len(evs) - copies, copies, host, busy / 1e3


def _dispatch(programs, case, refs):
    from rav1e_tpu_torch.device import chain

    return chain.dispatch_chain(
        programs, case["geom"], case["plan"], case["src"], refs,
        case["fields"], case["dcq8"], case["acq8"], case["dbl"],
        case["y_list"], case["uv_list"])


def chain_graph_check(case_a, case_b, eager_a, eager_b, keys, dev):
    """Graph replay against the eager stages on the card, for one key:
    frame A runs through a ChainPrograms as the key's first (eager) frame,
    frame B then captures the five graphs and replays them, frame A replays
    again.  After each run every stage output in the runner's static
    buffers equals the eager stages' on the same inputs, and what run B
    handed out (its reconstruction and levels copies) is still B's after
    run A's replay.  Returns the runner, with its graphs captured, and each
    run's host ms to enqueue (eager, capture + replay, replay)."""
    import torch

    from rav1e_tpu_torch.device.graphs import ChainPrograms

    programs = ChainPrograms(dev)
    g, yl, ul = case_a["geom"], case_a["y_list"], case_a["uv_list"]
    if (case_b["geom"], case_b["y_list"], case_b["uv_list"]) != (g, yl, ul):
        fail("chain graphs: the two frames are not of one key")
    handed, host_ms = None, []
    for i, (case, want) in enumerate(((case_a, eager_a), (case_b, eager_b),
                                      (case_a, eager_a))):
        refs = _device_refs(case, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref_out, _hdr, levels = programs.run(g, case["src"], refs,
                                             case["aux"], yl, ul)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        k = programs.key(g, yl, ul)
        bad = chain_equal(k.data, want, keys)
        if bad:
            fail(f"chain graphs, run {i + 1}: {bad} differ from the eager "
                 "stages")
        if i == 1:
            handed = (ref_out, levels)
    if chain_equal({"ref_out": handed[0], "levels": handed[1]}, eager_b,
                   ("ref_out", "levels")):
        fail("chain graphs: a replay changed the previous run's results")
    st = programs.stats()
    if (st["keys"], st["captured"], st["eager"], st["replays"]) != (1, 1, 1,
                                                                    2):
        fail(f"chain graphs: runner stats {st}, not one key, one eager "
             "frame and two replays")
    return programs, host_ms


def chain_phase(clip, dev):
    """The five stages on the card and on the CPU from identical inputs:
    every output exactly equal (and on all-zero MV fields, where the
    selection ties between candidates, the selection too); the card's
    graph replays equal to its eager stages twice in a row
    (:func:`chain_graph_check`); then each stage on the card timed and
    profiled eagerly and as a replay, and one steady-state frame's host
    launches counted.  Returns the report lines."""
    import torch

    from rav1e_tpu_torch.device import chain, kernels
    from rav1e_tpu_torch.device.graphs import ChainPrograms

    case = chain_case(clip, dev)
    g = case["geom"]
    got, calls = chain_calls(case, dev)
    want, _ = chain_calls(case, "cpu")
    keys = [k for _n, _c, ks in calls for k in ks]
    bad = chain_equal(got, want, keys)
    if bad:
        fail(f"chain stages: card != CPU in {bad}")
    if int(got["overflow"]) != 0:
        fail("chain stages: the case overflowed its levels budget")
    zero = case["aux"].copy()
    o, n = chain._aux_layout(g)[0]["fields"]
    zero[o : o + n] = 0
    zg, _ = chain_calls(case, dev, zero)
    zc, _ = chain_calls(case, "cpu", zero)
    bad = chain_equal(zg, zc, ["pred_y", "sels"])
    if bad:
        fail(f"chain stages, all-zero fields: card != CPU in {bad}")
    nsel = sum(int((s == 3).sum()) for s in _flat(zc["sels"]))
    if nsel:
        fail(f"chain stages, all-zero fields: {nsel} cells took candidate 3 "
             "over the tied candidate 0")
    lines = [f"{len(keys)} outputs equal card vs CPU ({g.gh}x{g.gw} grid, "
             f"{case['plan'].n_tx} tx blocks, "
             f"{int(got['eob_ord'][: g.ntx_cap].sum())} levels); tied "
             "selection equal"]

    case_b = chain_case(clip, dev, CHAIN_FRAMES_B)
    got_b, _ = chain_calls(case_b, dev)
    programs, host_ms = chain_graph_check(case, case_b, got, got_b, keys,
                                          dev)
    lines.append(f"graph replay == eager stages for all {len(keys)} outputs, "
                 "twice in a row (frames "
                 f"{CHAIN_FRAMES_B[0]} then {CHAIN_FRAMES[0]}), and the "
                 "earlier run's copies kept")
    lines.append("runner host ms to enqueue a frame: eager "
                 f"{host_ms[0]:.3f}, capture + replay {host_ms[1]:.3f}, "
                 f"replay {host_ms[2]:.3f}")

    graphs = programs.key(g, case["y_list"], case["uv_list"]).graphs
    total = {"eager": [0.0, 0, 0, 0.0], "replay": [0.0, 0, 0, 0.0]}
    for (name, call, _keys), graph in zip(calls, graphs):
        row = []
        for how, fn in (("eager", call), ("replay", graph.replay)):
            ms = cuda_ms(fn, 5)
            kern, _copies, host, busy = profile_call(fn)
            row.append(f"{how} ms={ms:.3f} host_launches={host} "
                       f"kernels={kern} device_busy_ms={busy:.3f}")
            for i, v in enumerate((ms, host, kern, busy)):
                total[how][i] += v
        lines.append(f"stage {name:16s} " + " | ".join(row))
        if name == "deblock+CDEF":
            # the filter kernels one run launches, eagerly and as a replay
            with kernels.counting_capture() as eager_tally:
                call()
            tallies = [{k: t[k] for k in FILTER_KERNELS}
                       for t in (eager_tally, graph.launches)]
            if tallies != [ROUTE_LAUNCHES["chain"]] * 2:
                fail(f"chain stages: stage 4 launched {tallies[0]} eagerly "
                     f"and {tallies[1]} as a replay, not "
                     f"{ROUTE_LAUNCHES['chain']}")
            lines.append(f"stage {name:16s} kernel launches a run: eager "
                         f"{tallies[0]} | replay {tallies[1]}")
    lines.append(f"stage {'all five':16s} " + " | ".join(
        f"{how} ms={t[0]:.3f} host_launches={t[1]} kernels={t[2]} "
        f"device_busy_ms={t[3]:.3f}" for how, t in total.items()))

    # one whole dispatch + fetch: a fresh runner's first (eager) frame
    # against a steady-state replay of the captured runner
    refs = _device_refs(case, dev)
    frame = {}
    for how, runner in (("eager", lambda: ChainPrograms(dev)),
                        ("replay", lambda: programs)):
        def one():
            chain.fetch_chain(_dispatch(runner(), case, refs))

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one()
        host_ms = (time.perf_counter() - t0) * 1e3
        _kern, copies, host, busy = profile_call(one)
        frame[how] = host
        lines.append(f"frame dispatch+fetch, {how}: host_ms={host_ms:.3f} "
                     f"(first call) host_launches={host} copies={copies} "
                     f"device_busy_ms={busy:.3f} (profiled call)")
    if not frame["eager"]:
        fail("chain stages: the profiler recorded no host launch")
    if frame["replay"] >= 100:
        fail(f"chain stages: a steady-state frame made {frame['replay']} "
             "host launches, not fewer than 100")
    return lines


# ---------------------------------------------------------------------------
# phase 7: whole-frame analysis, card against CPU
# ---------------------------------------------------------------------------



def analysis_phase(clip, dev):
    import torch

    from rav1e_tpu_torch import tables
    from rav1e_tpu_torch.device import analysis

    qi = QUANTIZER
    q_step = tables.ac_q(qi, 0, 8) / 8.0
    lam = 0.12 * q_step * q_step
    luma = [planes[0] for planes in clip]
    cases = (("key", 0, None, None), ("inter", 1, 0, None),
             ("inter+bwd", 2, 0, 4))
    report = []
    for name, cur, fwd, bwd in cases:
        outs = {}
        for d in ("cpu", dev):
            planes = [analysis.upload_source_luma(luma[i], d).to(torch.int32)
                      if i is not None else None for i in (cur, fwd, bwd)]
            has_inter = fwd is not None
            has_bwd = bwd is not None
            q = torch.tensor(float(tables.ac_q(qi, 0, 8)),
                             dtype=torch.float32, device=d)
            lam_t = torch.tensor(lam, dtype=torch.float32, device=d)
            gaps = {}
            ref0 = planes[1] if has_inter else planes[0]
            ref1 = planes[2] if has_bwd else ref0
            out = analysis._frame_analysis(planes[0], ref0, ref1, ref0, q,
                                           lam_t, 8, has_inter, has_bwd,
                                           False, gaps)
            outs[d] = [o.cpu() for o in out[:7]] + [gaps["min"].cpu()]
        c, g = outs["cpu"], outs[dev]
        for mi in (4, 5):
            if not torch.equal(c[mi], g[mi]):
                fail(f"analysis {name}: MV field {mi - 4} differs")
        differ = torch.zeros_like(c[0], dtype=torch.bool)
        for k in (0, 1, 2):
            differ |= c[k] != g[k]
        ndiff = int(differ.sum())
        worst = float(c[7][differ].max()) if ndiff else 0.0
        if ndiff and worst >= NEAR_TIE:
            fail(f"analysis {name}: {ndiff} cells differ, largest CPU gap "
                 f"{worst:.3g} is not a near-tie")
        report.append(f"{name}: {ndiff} of {differ.numel()} cells differ"
                      + (f" (largest gap {worst:.3g})" if ndiff else ""))
    return report + analysis_graph_check(clip, dev)


# the four keys of the analysis runner in a pyramid clip: (name, frame A,
# frame B), each frame its clip indices (subject, then forward, backward
# and far-backward references)
ANALYSIS_KEYS = (("intra", (0,), (1,)), ("fwd", (1, 0), (2, 1)),
                 ("fwd+bwd", (2, 0, 4), (3, 1, 5)),
                 ("fwd+bwd+bwd2", (2, 0, 4, 8), (3, 1, 5, 9)))
QUANTIZER_B = QUANTIZER + 20  # frame B's, so q and lambda change in a key
# host launches of a replayed analysis: the plane and scalar copies, one
# replay, one clone of the packed outputs
ANALYSIS_REPLAY_LAUNCHES = 10


def analysis_lam(qi):
    """The pipeline's lambda at quantizer ``qi`` (8 bits)."""
    from rav1e_tpu_torch import tables

    return 0.12 * (tables.ac_q(qi, 0, 8) / 8.0) ** 2


def key_flags(idx):
    """(has_inter, has_bwd, has_bwd2) of a frame given as its clip indices."""
    return (len(idx) > 1, len(idx) > 2, len(idx) > 3)


def key_planes(luma, idx):
    """(luma, ref0, ref1, ref2) of a frame as the eager analysis takes
    them: the references its key does not read stand in as the whole-frame
    run has them."""
    p = [luma[i] for i in idx] + [None] * (4 - len(idx))
    f = key_flags(idx)
    ref0 = p[1] if f[0] else p[0]
    ref1 = p[2] if f[1] else ref0
    return p[0], ref0, ref1, p[3] if f[2] else ref0


def key_dispatch(luma, dev, runner, idx, qi):
    """``analyze_frame_async`` of frame ``idx`` through ``runner``, as the
    pipeline calls it."""
    from rav1e_tpu_torch.device import analysis

    refs = [luma[i] for i in idx[1:]] + [None] * (4 - len(idx))
    return analysis.analyze_frame_async(
        luma[idx[0]], refs[0], refs[1], qi, analysis_lam(qi), 8,
        ref2_np=refs[2], device=dev, programs=runner)


def key_graph_rows(what, dispatch, runner, profiled, name, a, b, want,
                   limit):
    """One analysis key through ``runner`` (``dispatch(runner, idx, qi)``):
    frame A eager, frame B (QUANTIZER_B) capturing, A replayed, each equal
    to ``want[idx]`` (the eager outputs and kernel launches) in all seven
    outputs and in launch counts, then B and A dispatched before either is
    read, each equal to its own.  Per run: host ms to enqueue, CUDA-event
    ms, and from torch.profiler (the same run through ``profiled``) host
    launches, kernels, copies and device-busy ms; a whole replay must make
    at most ``limit`` host launches (None: no limit).  Returns the report
    row and the replay's CUDA-event ms over 5."""
    import torch

    from rav1e_tpu_torch.device import kernels

    row = []
    for how, idx, qi in (("eager", a, QUANTIZER), ("capture", b, QUANTIZER_B),
                         ("replay", a, QUANTIZER)):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        kernels.reset_launches()
        ev[0].record()
        t0 = time.perf_counter()
        h = dispatch(runner, idx, qi)
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[1].record()
        torch.cuda.synchronize()
        same_outputs(h, want[idx][0], what, f"{name} {how} frame {idx}")
        if dict(kernels.LAUNCHES) != want[idx][1]:
            fail(f"{what}: {name} {how} counted launches {kernels.LAUNCHES}"
                 f", the eager run {want[idx][1]}")
        kern, copies, host, busy = profile_call(
            lambda: dispatch(profiled, idx, qi))
        row.append(f"{how} host_ms={host_ms:.3f} "
                   f"ms={ev[0].elapsed_time(ev[1]):.3f} "
                   f"host_launches={host} kernels={kern} copies={copies} "
                   f"device_busy_ms={busy:.3f}")
        if how == "replay" and limit is not None and host > limit:
            fail(f"{what}: a {name} replay made {host} host launches, more "
                 f"than {limit}")
    hb = dispatch(runner, b, QUANTIZER_B)
    ha = dispatch(runner, a, QUANTIZER)
    same_outputs(hb, want[b][0], what, f"{name}: of two dispatches, the first")
    same_outputs(ha, want[a][0], what,
                 f"{name}: of two dispatches, the second")
    return " | ".join(row), cuda_ms(lambda: dispatch(runner, a, QUANTIZER), 5)


def same_outputs(handle, want, what, which):
    import torch

    if not all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(handle[0], want)):
        fail(f"{what}: {which} differs from the eager run")


def analysis_graph_check(clip, dev):
    """The analysis as CUDA graphs (``AnalysisPrograms``) at 1080p, for each
    of the four keys, through ``analyze_frame_async`` as the pipeline calls
    it (:func:`key_graph_rows`: eager, capturing, replayed, two dispatches
    kept apart), each held to ``_frame_analysis`` run eagerly on the card;
    a replay must make at most ANALYSIS_REPLAY_LAUNCHES host launches.  One
    runner holds all four keys, as a pipeline's does; after the last key
    each key's frame B replays to its eager result again.  Returns the
    report lines."""
    import torch

    from rav1e_tpu_torch.device import analysis, kernels
    from rav1e_tpu_torch.device.graphs import AnalysisPrograms

    luma = [analysis.upload_source_luma(clip[i][0], dev) for i in range(10)]
    what = "analysis graphs"

    def dispatch(runner, idx, qi):
        return key_dispatch(luma, dev, runner, idx, qi)

    def eager(idx, qi):
        planes = [p.to(torch.int32) for p in key_planes(luma, idx)]
        q, lt = analysis._scalars(qi, analysis_lam(qi), 8, dev)
        kernels.reset_launches()
        out = analysis._frame_analysis(*planes, q, lt, 8, *key_flags(idx))
        return out[:7], dict(kernels.LAUNCHES)

    runner, profiled = AnalysisPrograms(dev), AnalysisPrograms(dev)
    lines, wants = [], {}
    for name, a, b in ANALYSIS_KEYS:
        want = {a: eager(a, QUANTIZER), b: eager(b, QUANTIZER_B)}
        wants[name] = (b, want[b][0])
        row, ms = key_graph_rows(what, dispatch, runner, profiled, name, a,
                                 b, want, ANALYSIS_REPLAY_LAUNCHES)
        lines.append(f"{what} {name:12s} {row} | replay ms over 5={ms:.3f}; "
                     f"launches {want[a][1]}; == eager, two dispatches kept")
    for name, (b, want) in wants.items():
        same_outputs(dispatch(runner, b, QUANTIZER_B), want, what,
                     f"{name} after all keys")
    st = runner.stats()
    if (st["keys"], st["captured"], st["eager"]) != (4, 4, 4):
        fail(f"{what}: runner stats {st}")
    lines.append(f"{what}: 4 keys in one runner, {st['replays']} "
                 f"replays, each key's frame B == eager again after all "
                 f"keys; pool {st['pool_bytes']} bytes")
    return lines


def small_clip_phase(rav1e_tpu_torch, dev):
    """A 256x128 6-frame clip through the same preset (chain on) on the card
    and on the CPU (plain versions): the packets must be byte-identical (the
    CPU path is the one tests/test_torch_encode.py holds
    byte-identical to rav1e_tpu)."""
    w, h = 256, 128
    clip = synth_clip(w, h, 6, np.random.default_rng(SEED))
    got = {d: encode(slice_config(rav1e_tpu_torch, d, w, h).new_context(),
                     clip, rav1e_tpu_torch)
           for d in (dev, "cpu")}
    a, b = got[dev], got["cpu"]
    if len(a) != len(b) or any(x.data != y.data for x, y in zip(a, b)):
        fail("small clip: packets on the card differ from the CPU's")
    return f"{len(a)} packets byte-identical card vs CPU"


# ---------------------------------------------------------------------------
# phase 9: the command-line encoder
# ---------------------------------------------------------------------------


def subprocess_env():
    """The environment of a child that imports the port from this checkout
    (and, embedded in a C program, finds this interpreter's packages)."""
    paths = [ROOT] + [q for q in sys.path if q and os.path.isdir(q)]
    return dict(os.environ, PYTHONPATH=os.pathsep.join(paths))


def write_y4m(path, clip, w, h):
    from rav1e_tpu_torch.config import ChromaSampling
    from rav1e_tpu_torch.io import Y4MWriter

    with open(path, "wb") as f:
        y4m = Y4MWriter(f, w, h, 30, 1, ChromaSampling.Cs420, 8)
        for planes in clip:
            y4m.write_frame(planes)


def cli_phase(clip, slice_pkts, tmp):
    """``python -m rav1e_tpu_torch.cli`` on the slice's clip, on the card
    (no --device: the CLI's default), with the slice's settings.  Returns
    the report, the kernel launches the CLI printed, and the frames of its
    -r reconstruction for the decode phase."""
    from rav1e_tpu_torch.io import Y4MReader, read_ivf

    src, ivf, rec = (os.path.join(tmp, n)
                     for n in ("clip.y4m", "out.ivf", "rec.y4m"))
    write_y4m(src, clip, WIDTH, HEIGHT)
    cmd = [sys.executable, "-m", "rav1e_tpu_torch.cli", src, "-o", ivf,
           "-r", rec, "--benchmark", "-s", "6", "-q", str(QUANTIZER),
           "-i", "0", "-I", "9999"]
    out = subprocess.run(cmd, cwd=ROOT, env=subprocess_env(),
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        fail(f"cli: exit code {out.returncode}\n{out.stderr[-3000:]}")
    err = out.stderr
    fps = re.search(r"encoded (\d+) frames in ([\d.]+)s \(([\d.]+) fps\)",
                    err)
    chain = re.search(r"chain_replay_code: .* x(\d+)", err)
    kline = re.search(r"kernel launches: (.*)", err)
    if not fps or not kline:
        fail(f"cli: no benchmark summary in its output\n{err[-3000:]}")
    launches = {k: int(v) for k, v in re.findall(r"(\w+)=(\d+)",
                                                  kline.group(1))}
    with open(ivf, "rb") as f:
        payloads = [data for _pts, data in read_ivf(f)]
    if payloads != [p.data for p in slice_pkts]:
        fail(f"cli: its {len(payloads)} IVF payloads differ from the "
             f"slice's {len(slice_pkts)} packets")
    with open(rec, "rb") as f:
        shown = list(Y4MReader(f))
    for name in ("satd8", "grid_search"):
        if launches.get(name, 0) <= 0:
            fail(f"cli: kernel {name} was not launched")
    report = (f"{len(payloads)} IVF payloads equal the slice's packets; "
              f"{fps.group(1)} frames at {fps.group(3)} frames/s "
              f"({fps.group(2)} s); {chain.group(1) if chain else 0} chain "
              f"frames; launches {launches}")
    return report, launches, shown


# ---------------------------------------------------------------------------
# phase 11: the C API
# ---------------------------------------------------------------------------


def python_embed_flags():
    """Compile and link flags of an embedded interpreter like this one."""
    import shutil
    import sysconfig

    for exe in (f"python{sys.version_info.major}.{sys.version_info.minor}"
                "-config", "python3-config"):
        if shutil.which(exe):
            inc = subprocess.run([exe, "--includes"], capture_output=True,
                                 text=True).stdout.split()
            ld = subprocess.run([exe, "--ldflags", "--embed"],
                                capture_output=True, text=True).stdout.split()
            if inc and ld:
                return inc, ld
    v = sysconfig.get_config_var
    return ([f"-I{sysconfig.get_paths()['include']}"],
            [f"-L{v('LIBDIR')}", f"-lpython{v('LDVERSION')}",
             *(v("LIBS") or "").split(), *(v("SYSLIBS") or "").split()])


def capi_replay(device):
    """The example's encode (capi/capi_encode.c) through capi_glue in this
    process, with the context's exceptions visible: the shim reports only a
    status.  Returns the packet lines the example prints."""
    from rav1e_tpu_torch import EncoderStatus, capi_glue as g

    w, h = 96, 64
    cfg = g.config_new()
    for k, v in (("width", w), ("height", h), ("speed", 10),
                 ("quantizer", 120), ("low_latency", 1), ("device", device)):
        g.config_set(cfg, k, str(v))
    ctx = g.context_new(cfg)
    for i in range(5):
        f = g.frame_new(ctx)
        y = ((np.arange(w * h) + i * 7) & 0xFF).astype(np.uint8).tobytes()
        for pl, (data, stride) in enumerate(
                ((y, w), (bytes([100 + i]) * (w * h // 4), w // 2),
                 (bytes([160 - i]) * (w * h // 4), w // 2))):
            g.frame_fill_plane(f, pl, data, stride, 1)
        ctx.send_frame(f)
    ctx.flush()
    lines = []
    while True:
        try:
            pkt = ctx.receive_packet()
        except EncoderStatus.LimitReached:
            return lines
        lines.append(f"packet {len(lines)}: frame {pkt.input_frameno} type "
                     f"{int(pkt.frame_type)} {len(pkt.data)} bytes")


def capi_phase():
    """The port's C shim and example built with g++, run on the card and on
    the CPU: identical packet lines."""
    inc, ld = python_embed_flags()
    out_dir = os.path.join(ROOT, "build", "rav1e_tpu_torch")
    os.makedirs(out_dir, exist_ok=True)
    exe = os.path.join(out_dir, "capi_encode")
    capi = os.path.join(ROOT, "rav1e_tpu_torch", "capi")
    t = time.monotonic()
    build = subprocess.run(
        ["g++", "-O2", os.path.join(capi, "capi.cc"),
         os.path.join(capi, "capi_encode.c"),
         "-I" + os.path.join(ROOT, "include"), *inc, *ld, "-o", exe],
        capture_output=True, text=True, timeout=300)
    if build.returncode != 0:
        fail(f"capi: g++ failed\n{build.stderr[-3000:]}")
    build_s = time.monotonic() - t
    lines = {}
    for dev in ("cuda", "cpu"):
        run = subprocess.run([exe, dev], cwd=ROOT, env=subprocess_env(),
                             capture_output=True, text=True, timeout=300)
        if run.returncode != 0:
            print(f"capi ({dev}): exit code {run.returncode}\n{run.stdout}"
                  f"\n{run.stderr[-3000:]}\nthe same encode in this "
                  "process:", flush=True)
            capi_replay(dev)
            fail(f"capi ({dev}): exit code {run.returncode}, and the same "
                 "encode in this process did not fail")
        lines[dev] = [ln for ln in run.stdout.splitlines()
                      if ln.startswith("packet ")]
    if not lines["cuda"] or lines["cuda"] != lines["cpu"]:
        fail(f"capi: card and CPU packets differ:\n{lines}")
    return (f"built in {build_s:.3f} s; {len(lines['cuda'])} packet lines "
            "identical card vs CPU")


# ---------------------------------------------------------------------------
# phase 10: GOP-parallel encoding on one card
# ---------------------------------------------------------------------------


def gop_config(r, slots):
    cfg = slice_config(r)
    cfg.enc.min_key_frame_interval = GOP_LEN
    cfg.enc.max_key_frame_interval = GOP_LEN
    cfg.parallel_gops = slots
    return cfg


def channel_encode(cfg, clip):
    sender, receiver = cfg.new_channel()
    for planes in clip:
        f = sender.new_frame()
        for p, arr in zip(f.planes, planes):
            p.copy_from(arr)
        sender.send(f)
    sender.close()
    return list(receiver)


def device_activity(prof):
    """(device-busy ms, the most CUDA streams busy at once) of a profiled
    run: the union of the device activities' intervals, and a sweep over
    each stream's merged intervals."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    by_stream = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            s0 = e.start_ns()
            by_stream.setdefault(e.device_resource_id(), []).append(
                (s0, s0 + e.duration_ns()))

    def merged(spans):
        out = []
        for s0, s1 in sorted(spans):
            if out and s0 <= out[-1][1]:
                out[-1][1] = max(out[-1][1], s1)
            else:
                out.append([s0, s1])
        return out

    busy = sum(s1 - s0 for s0, s1 in
               merged([x for v in by_stream.values() for x in v]))
    edges = sorted((t, d) for v in by_stream.values()
                   for s0, s1 in merged(v) for t, d in ((s0, 1), (s1, -1)))
    now = most = 0
    for _t, d in edges:  # at equal times an end (-1) sorts before a start
        now += d
        most = max(most, now)
    return busy / 1e6, most


def _decode_chunk(triples):
    return decode_mismatch(triples)


def gop_run(r, slots, clip, profiled):
    """One channel with ``slots`` GOP slots (0: serial) over ``clip``, its
    launch counts set to 0 just before and read just after: its packets and
    numbers, with the device's busy time and the most streams busy at once
    when ``profiled``."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from rav1e_tpu_torch.device import kernels
    from rav1e_tpu_torch.utils import trace

    cfg = gop_config(r, slots)
    trace.reset()
    torch.cuda.synchronize()
    reset_counts()
    prof = (profile(activities=[ProfilerActivity.CUDA]) if profiled
            else contextlib.nullcontext())
    with prof:
        t = time.monotonic()
        cpu = time.process_time()
        pkts = channel_encode(cfg, clip)
        torch.cuda.synchronize()
        wall = time.monotonic() - t
        cpu = time.process_time() - cpu
    run = dict(pkts=pkts, launches=dict(kernels.LAUNCHES), wall=wall,
               fps=len(clip) / wall, profiled=profiled, cpu=cpu,
               chain=span_count(trace.stage_summary(), "chain_replay_code"),
               stop_s=time.monotonic() - t - wall)
    trace.reset()
    if len(pkts) < len(clip):
        fail(f"gop: {len(pkts)} packets for {len(clip)} frames "
             f"(parallel_gops={slots})")
    for name in (*ANALYSIS_KERNELS, *FILTER_KERNELS):
        if run["launches"].get(name, 0) <= 0:
            fail(f"gop (parallel_gops={slots}): kernel {name} was not "
                 "launched")
    err = filter_launch_fault(f"gop (parallel_gops={slots})",
                              run["launches"], dict(ROUTE_RUNS))
    if err:
        fail(err)
    if profiled:
        t = time.monotonic()
        busy_ms, streams = device_activity(prof)
        run.update(busy_ms=busy_ms, idle=1.0 - busy_ms / (wall * 1e3),
                   streams=streams, parse_s=time.monotonic() - t)
    return run


def gop_phase(r, decoders):
    """3 GOP slots against each chunk encoded alone, and a serial channel:
    each timed without the profiler and then under it, in turns (3 slots,
    serial, serial, 3 slots).  The 3-slot packets start decoding in the
    ``decoders`` pool, one chunk a process: returns the report, the launch
    counts and the pending decode, which the caller collects (after the
    phases that follow, since the decode takes longer than this phase)."""
    t = time.monotonic()
    clip = synth_clip(WIDTH, HEIGHT, GOP_FRAMES, np.random.default_rng(SEED))
    steps = [f"clip {time.monotonic() - t:.1f} s"]
    runs = []
    for slots, profiled in ((GOP_SLOTS, False), (0, False), (0, True),
                            (GOP_SLOTS, True)):
        runs.append((slots, gop_run(r, slots, clip, profiled)))
    par = runs[0][1]["pkts"]
    if [p.data for p in par] != [p.data for p in runs[3][1]["pkts"]]:
        fail("gop: the 3-slot packets differ between two runs")
    # each chunk starts at a keyframe, so each decodes on its own: the 3-slot
    # packets decode in worker processes while the chunks encode alone here
    bounds = [0] + [i for i, p in enumerate(par)
                    if p.input_frameno % GOP_LEN == 0 and i > 0
                    and p.frame_type.name == "KEY"] + [len(par)]
    chunks = [decode_triples(par[a:b]) for a, b in zip(bounds, bounds[1:])]
    decoded = decoders.map_async(_decode_chunk, chunks)
    t = time.monotonic()
    want = []
    for c in range(GOP_FRAMES // GOP_LEN):
        ctx = gop_config(r, 0).new_context()
        chunk = encode(ctx, clip[c * GOP_LEN : (c + 1) * GOP_LEN], r)
        for p in chunk:
            p.input_frameno += c * GOP_LEN
        want.append(chunk)
    steps.append(f"chunks alone {time.monotonic() - t:.1f} s")
    flat = [p for chunk in want for p in chunk]
    if len(par) != len(flat) or any(
            (a.data, a.input_frameno) != (b.data, b.input_frameno)
            for a, b in zip(par, flat)):
        fail("gop: the 3-slot packets differ from the chunks encoded alone")
    if len(chunks) != len(want):
        fail(f"gop: {len(chunks)} keyframe-led chunks for {len(want)}")
    lines = [f"{len(par)} packets of {GOP_SLOTS} slots equal the "
             f"{len(want)} chunks encoded alone"]
    for slots, run in runs:
        line = (f"parallel_gops={slots}{' profiled' if run['profiled'] else ''}"
                f": {run['fps']:.4f} frames/s ({GOP_FRAMES} frames in "
                f"{run['wall']:.3f} s, host CPU {run['cpu']:.3f} s), "
                f"{run['chain']} chain frames, launches {run['launches']}")
        if run["profiled"]:
            line += (f", device busy {run['busy_ms']:.1f} ms, idle share "
                     f"{run['idle']:.6f}, most streams busy at once "
                     f"{run['streams']}")
        lines.append(line)
        steps.append(f"stop {run['stop_s']:.1f} s"
                     + (f" parse {run['parse_s']:.1f} s" if run["profiled"]
                        else ""))
    t = time.monotonic()
    lines += gop_chunks_case(r)
    steps.append(f"chunks case {time.monotonic() - t:.1f} s")
    lines.append("steps: " + "; ".join(steps))
    return lines, runs[0][1]["launches"], decoded


# more chunks than slots: bench.py's clip settings over 48 frames with a
# key frame every 8, on 3 slots, so chunks 4-6 take the sets chunks 1-3
# returned
CHUNKS_FRAMES, CHUNKS_LEN = 48, 8


def gop_chunks_case(r):
    """bench.py's clip settings (reference_cells.py's ``bench clip``, 48
    frames of its pan, a key frame every 8) through 3 GOP slots: the
    packets equal each chunk encoded alone, the chunks' contexts hold at
    most 3 sets, no key of a set is captured twice, and the 4th to 6th
    contexts the channel makes (chunks 4-6, taken in order from its queue)
    run no key eagerly.  Returns the report lines."""
    cell = reference_cells.CELLS["bench clip"]
    w, h = cell["width"], cell["height"]
    clip = reference_cells.pan_runs(w, h, [CHUNKS_FRAMES],
                                    np.random.default_rng(cell["seed"]))[0]

    def config(slots):
        enc = reference_cells.encoder_config(r, cell)
        enc.min_key_frame_interval = enc.max_key_frame_interval = CHUNKS_LEN
        return r.Config(enc=enc, device="cuda", parallel_gops=slots)

    cfg = config(GOP_SLOTS)
    made = []

    def new_context(make=cfg.new_context):
        ctx = make()
        made.append(ctx)
        return ctx

    cfg.new_context = new_context
    t = time.monotonic()
    par = channel_encode(cfg, clip)
    par_s = time.monotonic() - t
    chunks = [c.pipeline for c in made[1:]]  # made[0]: the template
    n = CHUNKS_FRAMES // CHUNKS_LEN
    lines = [f"{n} chunks of {CHUNKS_LEN} frames at {w}x{h} on {GOP_SLOTS} "
             f"slots: {CHUNKS_FRAMES / par_s:.4f} frames/s"]
    alone = []
    for c in range(n):
        ctx = config(0).new_context()
        chunk = encode(ctx, clip[c * CHUNKS_LEN : (c + 1) * CHUNKS_LEN], r)
        for p in chunk:
            p.input_frameno += c * CHUNKS_LEN
        alone += chunk
    if len(par) != len(alone) or any(
            (a.data, a.input_frameno) != (b.data, b.input_frameno)
            for a, b in zip(par, alone)):
        fail(f"gop: the {n} chunks on {GOP_SLOTS} slots differ from the "
             "chunks encoded alone")
    if made[0].pipeline._programs is not None or len(chunks) != n:
        fail(f"gop: {len(chunks)} chunk contexts for {n} chunks, or the "
             "template context holds a set")
    sets = {id(p._programs): p._programs for p in chunks}
    if len(sets) > GOP_SLOTS:
        fail(f"gop: {len(sets)} sets for {GOP_SLOTS} slots")
    for i, p in enumerate(chunks):
        own = {k: {m: v for m, v in st.items() if m != "set"}
               for k, st in p.program_stats().items()}
        lines.append(f"chunk context {i + 1}: set "
                     f"{list(sets).index(id(p._programs))}, {own}")
        eager = {k: v["eager"] for k, v in own.items() if v["eager"]}
        if i >= GOP_SLOTS and eager:
            fail(f"gop: chunk context {i + 1} ran keys eagerly: {eager}")
    for i, pset in enumerate(sets.values()):
        for name, st in pset.stats().items():
            err = set_fault(name, st)
            if err:
                fail(f"gop: set {i}: {err}")
            lines.append(f"set {i} {name}: {st['keys']} keys, "
                         f"{st['captures']} captures, {st['replays']} "
                         f"replays, pool {st['pool_bytes']} bytes")
    lines.append(f"{len(par)} packets of {GOP_SLOTS} slots equal the {n} "
                 f"chunks encoded alone, through {len(sets)} sets")
    return lines


def gop_decode_check(decoded):
    errs = decoded.get(timeout=900)
    if any(errs):
        fail(f"gop: {[e for e in errs if e]}")
    return (f"the {len(errs)} chunks of the 3-slot packets decode to their "
            "rec")


# ---------------------------------------------------------------------------
# phase 12: the other bit depths, chroma formats, tilings and presets
# ---------------------------------------------------------------------------

# reference_cells.py's ten configurations (10 and 12 bit, 4:2:2, 4:4:4,
# 2x2 tiles, low latency, speeds 8, 9 and 10, a ragged clip), here at
# 256x128 (the ragged one at 200x136) and 6 frames
CONFIGS = tuple(n for n, c in reference_cells.CELLS.items()
                if c["kind"] == "synth")
CONFIG_SIZE = {"ragged 200x136 s6": (200, 136)}
# the first four seeds whose random configuration reaches the device stages
# (speed >= 6, both sides >= 64): 12-bit 4:4:4, 8-bit monochrome, 10-bit
# 4:2:2 with two tile rows, and 8-bit 4:2:0 at 127x123
FUZZ_SEEDS = tuple(c["seed"] for c in reference_cells.CELLS.values()
                   if c["kind"] == "fuzz")


def config_case(r, i, device):
    """Configuration i of CONFIGS over a 6-frame seeded clip on
    ``device``: (packets, chain frames, kernel launches)."""
    from rav1e_tpu_torch.device import kernels
    from rav1e_tpu_torch.utils import trace

    cell = dict(reference_cells.CELLS[CONFIGS[i]])
    w, h = CONFIG_SIZE.get(CONFIGS[i], (256, 128))
    cell.update(width=w, height=h, frames=6)
    enc = reference_cells.encoder_config(r, cell)
    ctx = r.Config(enc=enc, device=device).new_context()
    clip = reference_cells.clip(cell, enc)
    trace.trace_enable()
    trace.reset()
    kernels.reset_launches()
    pkts = encode(ctx, clip, r)
    chain = span_count(trace.stage_summary(), "chain_replay_code")
    trace.reset()
    return pkts, chain, dict(kernels.LAUNCHES), graph_counts(ctx, chain)


def _config_case_cpu(i):
    import torch

    import rav1e_tpu_torch

    torch.set_num_threads(2)
    pkts, chain, _, _ = config_case(rav1e_tpu_torch, i, "cpu")
    return [p.data for p in pkts], chain


def configs_phase(r, dev):
    """Each configuration on the card, against the CPU's packets encoded
    meanwhile by worker processes; then the fuzz seeds on the card."""
    import multiprocessing

    from rav1e_tpu_torch.device import kernels
    from rav1e_tpu_torch.utils import fuzzing

    lines = []
    with multiprocessing.get_context("spawn").Pool(4) as pool:
        cpu = pool.map_async(_config_case_cpu, range(len(CONFIGS)))
        card = [config_case(r, i, dev) for i in range(len(CONFIGS))]
        cpu = cpu.get(timeout=900)
    for label, (pkts, chain, launches, (graphs, err)), (want, cchain) in zip(
            CONFIGS, card, cpu):
        if [p.data for p in pkts] != want:
            fail(f"configs {label}: card packets differ from the CPU's")
        if err:
            fail(f"configs {label}: {err}")
        lines.append(f"{label:18s} {len(pkts)} packets equal card vs CPU; "
                     f"chain frames {chain} (CPU {cchain}); {graphs}; "
                     f"launches {launches}")
    for seed in FUZZ_SEEDS:
        kernels.reset_launches()
        n = fuzzing.fuzz_encode_decode(seed, dev)
        lines.append(f"fuzz seed {seed}: {n} packets decode to their rec; "
                     f"launches {dict(kernels.LAUNCHES)}")
    return lines


# ---------------------------------------------------------------------------
# phase 13: the card against rav1e_tpu's stored packets
# ---------------------------------------------------------------------------

STORE = os.path.join(ROOT, "tests", "data", "torch_reference_packets.json")


def reference_cell(r, dev, name, want):
    """Cell ``name`` encoded on the card against rav1e_tpu's stored record
    ``want``: (report line, faults, kernel launches, the pipeline's own
    runs of each replayed program)."""
    from rav1e_tpu_torch.device import kernels

    cell = reference_cells.CELLS[name]
    bad = []
    t = time.monotonic()
    reset_counts()
    pkts, ctx, spans = reference_cells.encode_traced(r, name, device=dev)
    launches = dict(kernels.LAUNCHES)
    err = filter_launch_fault(name, launches, dict(ROUTE_RUNS))
    if err:
        bad.append(err)
    graphs, graph_err = graph_counts(ctx, spans["chain_replay_code"])
    own = {k: {n: v for n, v in st.items() if n != "set"}
           for k, st in ctx.pipeline.program_stats().items()}
    del ctx
    if graph_err:
        bad.append(f"{name}: {graph_err}")
    enc_s = time.monotonic() - t
    got = [reference_cells.packet_record(p) for p in pkts]
    err = reference_cells.first_difference(got, want["packets"])
    if err:
        cpu, _, _ = reference_cells.encode_traced(r, name, device="cpu")
        cpu_err = reference_cells.first_difference(
            [reference_cells.packet_record(p) for p in cpu], want["packets"])
        bad.append(f"{name}: {err}; on the CPU "
                   + (f"the port differs too: {cpu_err}" if cpu_err
                      else "the port gives rav1e_tpu's packets, so the card "
                      "differs"))
    t = time.monotonic()
    dec_err = decode_mismatch(decode_triples(pkts))
    if dec_err:
        bad.append(f"{name}: {dec_err}")
    inter = any(p["frame_type"] != "KEY" for p in want["packets"])
    for k, need in (("satd8", True), ("grid_search", inter)):
        if need and launches.get(k, 0) <= 0:
            bad.append(f"{name}: kernel {k} was not launched")
    if spans != want["spans"]:
        bad.append(f"{name}: stage spans {spans}, rav1e_tpu's "
                   f"{want['spans']}")
    if spans["device_analysis"] < 1:
        bad.append(f"{name}: no device analysis")
    if cell["chain"] and spans["chain_replay_code"] < 1:
        bad.append(f"{name}: no frame was coded by the chain")
    line = (f"{name:24s} {len(pkts)} packets "
            f"{'== rav1e_tpu' if not err else 'DIFFER'}; chain frames "
            f"{spans['chain_replay_code']} (overflow "
            f"{spans['chain_overflow']}, diverged {spans['chain_diverged']}"
            f"); {graphs}; launches {launches}; encode {enc_s:.3f} s, decode "
            f"{time.monotonic() - t:.3f} s")
    return line, bad, launches, own


def store_report(dev):
    """The store's sets on ``dev`` (``device/graphs.py`` ``STORE``): per set
    and runner its keys, captures and replays, and the pools' bytes; and
    the keys that ran once (eagerly, never captured)."""
    from rav1e_tpu_torch.device import graphs

    st = graphs.STORE.stats(dev)
    once = 0
    parts = []
    for i, sset in enumerate(st["by_set"]):
        for name, s in sset.items():
            once += sum(1 for *_, eager, replays in s["by_key"]
                        if eager == 1 and replays == 0)
            parts.append(f"set {i} {name}: {s['keys']} keys, "
                         f"{s['captures']} captures, {s['replays']} replays, "
                         f"pool {s['pool_bytes']} bytes")
    return (f"{st['sets']} sets ({st['in_use']} in use), pools "
            f"{st['pool_bytes']} bytes; " + "; ".join(parts)), once, st


def reference_phase(r, dev):
    """Every cell of reference_cells.py, the 640x384 16-frame bench clip
    included, encoded on the card with the kernels on: every packet's hash
    equals rav1e_tpu's (the store made by tools/torch_reference_packets.py),
    every packet decodes to its reconstruction through
    rav1e_tpu_torch.decoder, the device analysis ran in every cell, the
    chain in each cell where it runs, satd8 in every cell and grid_search
    in each cell with inter frames, with rav1e_tpu's count of each stage
    span.  Where a cell differs, the same cell
    encoded on the CPU says whether the card or the port differs.  Then the
    small cells once more, in reverse order, through the sets of runners
    the first pass left in the store: the same packets, spans and launches,
    no key run eagerly, and a capture only of a key the first pass ran
    once (a key's capture is its second run).  Returns the report and the
    launches of the first pass summed over the cells."""
    with open(STORE) as f:
        store = json.load(f)["cells"]
    missing = [n for n in reference_cells.CELLS if n not in store]
    if missing:
        fail(f"reference: the store has no packets for {missing}")
    lines, bad, total, by_cell = [], [], {}, {}
    for name, cell in reference_cells.CELLS.items():
        want = store[name]
        if want["settings"] != cell:
            bad.append(f"{name}: the store was made for other settings")
            continue
        line, errs, launches, _ = reference_cell(r, dev, name, want)
        lines.append(line)
        bad += errs
        by_cell[name] = launches
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    report, once, _ = store_report(dev)
    lines.append(f"after the first pass: {report}; {once} keys ran once")
    captures = 0
    for name in reversed(reference_cells.small_cells()):
        if name not in by_cell:
            continue
        line, errs, launches, own = reference_cell(r, dev, name, store[name])
        lines.append("second pass " + line)
        bad += [f"second pass {e}" for e in errs]
        if launches != by_cell[name]:
            bad.append(f"{name}: second pass launches {launches}, first "
                       f"{by_cell[name]}")
        eager = {k: v["eager"] for k, v in own.items() if v["eager"]}
        if eager:
            bad.append(f"{name}: the second pass ran keys eagerly: {eager}")
        captures += sum(v["captures"] for v in own.values())
    report, _, st = store_report(dev)
    lines.append(f"after the second pass: {report}; {captures} captures in "
                 f"the second pass, of {once} keys the first ran once")
    if captures > once:
        bad.append(f"the second pass made {captures} captures, more than "
                   f"the {once} keys the first pass ran once")
    for sset in st["by_set"]:
        bad += [e for name, s in sset.items() if (e := set_fault(name, s))]
    for line in lines:
        print("  " + line, flush=True)
    if bad:
        fail("reference: " + "; ".join(bad))
    return lines, total


# ---------------------------------------------------------------------------
# phase 14: the analysis mesh, four slots of the card
# ---------------------------------------------------------------------------

MESH_SLOTS = 4
MESH_FRAMES = 4
MESH_BITS_RTOL = 1e-5  # card vs CPU: float32 sums in other orders
# host launches of one band's replay (``BandPrograms.run``): the copies of
# its windows and of q/lambda into the key's buffers, one graph launch, one
# clone of the packed outputs; the window's halo copies and the gather are
# not counted
BAND_REPLAY_LAUNCHES = 10
# the GOP channel under the mesh: 2 slots, 2 chunks of 4 frames
MESH_GOP_SLOTS, MESH_GOP_LEN = 2, 4


@contextlib.contextmanager
def using_mesh(mesh):
    """The pipeline's analysis mesh swapped for ``mesh`` (None: unsharded)
    in the body."""
    from rav1e_tpu_torch.device import analysis

    orig = analysis._analysis_mesh
    analysis._analysis_mesh = lambda device: mesh
    try:
        yield
    finally:
        analysis._analysis_mesh = orig


def mesh_encode(r, clip, mesh):
    """The slice's Config over ``clip`` with the analysis mesh swapped for
    ``mesh`` (None: unsharded) for the encode's duration; returns the
    packets, the kernels' launches, the seconds and the context."""
    import torch

    from rav1e_tpu_torch.device import kernels

    with using_mesh(mesh):
        ctx = slice_config(r).new_context()
        torch.cuda.synchronize()
        reset_counts()
        t = time.monotonic()
        pkts = encode(ctx, clip, r)
        torch.cuda.synchronize()
        s = time.monotonic() - t
    launches = dict(kernels.LAUNCHES)
    err = filter_launch_fault("mesh", launches, dict(ROUTE_RUNS))
    if err:
        fail(err)
    return pkts, launches, s, ctx


def band_graph_check(clip, mesh, dev):
    """The mesh analysis through band runners (``graphs.BandPrograms``, one
    CUDA graph per slot and key) at 1080p on ``mesh``, for each of the four
    analysis keys, through a set checked out of the store as a pipeline
    checks it out (:func:`key_graph_rows`: eager, capturing, replayed, two
    dispatches kept apart), each held to ``_mesh_frame_analysis`` run
    eagerly on the card; each slot's band replay must make at most
    BAND_REPLAY_LAUNCHES host launches.  After the last key each key's
    frame B replays to its eager result again.  The set goes back to the
    store, so the mesh encodes that follow replay from their first frame.
    Returns the report lines."""
    from rav1e_tpu_torch import tables
    from rav1e_tpu_torch.device import analysis, graphs, kernels
    from rav1e_tpu_torch.parallel.mesh import ANALYSIS_HALO, on_slot

    what = "mesh graphs"

    def dispatch(runner, idx, qi):
        return key_dispatch(luma, dev, runner, idx, qi)

    def eager(idx, qi):
        kernels.reset_launches()
        out = analysis._mesh_frame_analysis(mesh, rows, key_planes(luma, idx),
                                            qi, analysis_lam(qi), 8,
                                            key_flags(idx))
        return out, dict(kernels.LAUNCHES)

    def band_launches(runner, idx, qi):
        """Host launches of each slot's band replay of frame ``idx``."""
        h, out = rows[-1][1], []
        q, f = float(tables.ac_q(qi, 0, 8)), key_flags(idx)
        for i, (lo, hi) in enumerate(rows):
            top, bot = min(ANALYSIS_HALO, lo), min(ANALYSIS_HALO, h - hi)
            windows = [p.window(i, lo - top, hi + bot) if used else None
                       for p, used in zip(key_planes(luma, idx), (True, *f))]

            def run():
                with on_slot(mesh, i):
                    runner.band(mesh, i).run(*windows, top, hi - lo, q,
                                             analysis_lam(qi), 8, f)

            out.append(profile_call(run)[2])
        return out

    with using_mesh(mesh):
        luma = [analysis.upload_source_luma(clip[i][0], dev)
                for i in range(10)]
        rows = luma[0].rows
        pset = graphs.STORE.acquire(dev)
        pset.hold()
        runner, profiled = pset.analysis, graphs.AnalysisPrograms(dev)
        lines, wants = [], {}
        try:
            for name, a, b in ANALYSIS_KEYS:
                want = {a: eager(a, QUANTIZER), b: eager(b, QUANTIZER_B)}
                wants[name] = (b, want[b][0])
                row, ms = key_graph_rows(what, dispatch, runner, profiled,
                                         name, a, b, want, None)
                bands = band_launches(runner, a, QUANTIZER)
                if max(bands) > BAND_REPLAY_LAUNCHES:
                    fail(f"{what}: a {name} band replay made {bands} host "
                         f"launches, more than {BAND_REPLAY_LAUNCHES}")
                lines.append(
                    f"{what} {name:12s} {row} | band replays' host launches "
                    f"by slot {bands} | replay ms over 5={ms:.3f}; launches "
                    f"{want[a][1]}; == eager mesh, two dispatches kept")
            for name, (b, want) in wants.items():
                same_outputs(dispatch(runner, b, QUANTIZER_B), want, what,
                             f"{name} after all keys")
        finally:
            graphs.STORE.release(pset)
    for i in range(len(rows)):
        st = runner.band(mesh, i).stats()
        if (st["keys"], st["captured"], st["eager"]) != (4, 4, 4):
            fail(f"{what}: band {i} runner stats {st}")
        lines.append(f"{what}: band {i} rows {rows[i]}: 4 keys, "
                     f"{st['replays']} replays; pool {st['pool_bytes']} "
                     "bytes")
    return lines


def mesh_gop_case(r, clip, mesh):
    """A 2-slot GOP channel under the mesh (each worker's pipeline with a
    set of its own, their bands on the mesh's shared slot streams): the
    packets equal each chunk encoded alone under the same mesh."""
    cfg = slice_config(r)
    cfg.enc.min_key_frame_interval = MESH_GOP_LEN
    cfg.enc.max_key_frame_interval = MESH_GOP_LEN
    n = MESH_GOP_SLOTS * MESH_GOP_LEN
    with using_mesh(mesh):
        cfg.parallel_gops = MESH_GOP_SLOTS
        t = time.monotonic()
        par = channel_encode(cfg, clip[:n])
        par_s = time.monotonic() - t
        cfg.parallel_gops = 0
        alone = []
        for c in range(MESH_GOP_SLOTS):
            chunk = encode(cfg.new_context(),
                           clip[c * MESH_GOP_LEN : (c + 1) * MESH_GOP_LEN], r)
            for p in chunk:
                p.input_frameno += c * MESH_GOP_LEN
            alone += chunk
    if len(par) != len(alone) or any(
            (a.data, a.input_frameno) != (b.data, b.input_frameno)
            for a, b in zip(par, alone)):
        fail(f"mesh: the {MESH_GOP_SLOTS}-slot GOP channel under the mesh "
             "differs from its chunks encoded alone")
    return (f"{MESH_GOP_SLOTS}-slot GOP channel under the mesh, {n} frames "
            f"in chunks of {MESH_GOP_LEN}: {n / par_s:.4f} frames/s, "
            f"{len(par)} packets equal the chunks encoded alone")


def mesh_phase(r, clip, info):
    """The sharded analysis functions on MESH_SLOTS slots of cuda:0 against
    the same calls on as many CPU slots, the port's dryrun_multichip on the
    card's slots, the band runners against the eager mesh analysis
    (:func:`band_graph_check`), and chain-on 1080p encodes in turns
    (unsharded, mesh, mesh, unsharded): each mesh context gives the
    unsharded packets, which decode, and launches each kernel MESH_SLOTS
    times as often as the unsharded encode; the second mesh context runs
    no band key eagerly and captures none.  Then a GOP channel under the
    mesh (:func:`mesh_gop_case`).  Returns the report lines and the two
    mesh contexts' launches, summed."""
    from rav1e_tpu_torch import tables
    from rav1e_tpu_torch.parallel import (
        make_mesh,
        sharded_frame_analysis,
        sharded_inter_analysis,
    )
    from rav1e_tpu_torch.parallel.dryrun import dryrun_multichip
    from rav1e_tpu_torch.parallel.mesh import ShardedPlane

    lines = []
    card = make_mesh(MESH_SLOTS, devices=["cuda:0"] * MESH_SLOTS)
    cpu = make_mesh(MESH_SLOTS, devices=["cpu"] * MESH_SLOTS)
    # a 1024x1920 frame pair: four 256-row bands
    luma = clip[1][0][:1024].astype(np.int32)
    ref = clip[0][0][:1024].astype(np.int32)
    lam = 0.12 * (tables.ac_q(QUANTIZER, 0, 8) / 8.0) ** 2
    for name, fn in (
        ("intra", lambda m: sharded_frame_analysis(m, luma, QUANTIZER, lam)),
        ("inter", lambda m: sharded_inter_analysis(m, luma, ref, QUANTIZER,
                                                   lam)),
    ):
        t = time.monotonic()
        got = fn(card)
        card_s = time.monotonic() - t
        want = fn(cpu)
        for k, (a, b) in enumerate(zip(got[:-1], want[:-1])):
            if not np.array_equal(a, b):
                fail(f"mesh: sharded {name} output {k} differs card vs CPU "
                     f"in {int((a != b).sum())} cells")
        if abs(got[-1] - want[-1]) > MESH_BITS_RTOL * abs(want[-1]):
            fail(f"mesh: sharded {name} bits {got[-1]} vs CPU {want[-1]}")
        lines.append(f"sharded {name} 1024x1920 on {MESH_SLOTS} card slots "
                     f"== {MESH_SLOTS} CPU slots (bits {got[-1]} vs "
                     f"{want[-1]}); card {card_s:.3f} s")

    t = time.monotonic()
    dry = dryrun_multichip(MESH_SLOTS, devices=["cuda:0"] * MESH_SLOTS)
    lines.append(f"dryrun_multichip on {MESH_SLOTS} card slots: "
                 f"{len(dry['packets'])} packets equal unsharded; bits "
                 f"{dry['bits']}; {time.monotonic() - t:.3f} s")

    t = time.monotonic()
    lines += band_graph_check(clip, card, "cuda")
    lines.append(f"band graph check {time.monotonic() - t:.3f} s")

    sub = clip[:MESH_FRAMES]
    n = len(sub)
    runs = []
    for label, m in (("unsharded", None), ("mesh", card), ("mesh", card),
                     ("unsharded", None)):
        pkts, launches, s, ctx = mesh_encode(r, sub, m)
        # the band runners this context ran (a set may hold others, of the
        # meshes its earlier holders met)
        bands = {k: {c: v for c, v in st.items() if c != "set"}
                 for k, st in ctx.pipeline.program_stats().items()
                 if k.startswith("band") and st["eager"] + st["replays"]}
        sharded = any(isinstance(p, ShardedPlane)
                      for p in ctx.pipeline._dev_luma_cache.values())
        runs.append((label, pkts, launches, s, bands))
        lines.append(f"{n}-frame {WIDTH}x{HEIGHT} chain-on encode, {label}"
                     f" context {sum(r_[0] == label for r_ in runs)}: "
                     f"{n / s:.4f} frames/s, launches {launches}, band "
                     f"runners {bands} ({info})")
        if sharded != (m is not None):
            fail(f"mesh: the {label} encode sharded: {sharded}")
    want = runs[0][1]
    for i, (label, pkts, launches, s, bands) in enumerate(runs):
        if [p.data for p in pkts] != [p.data for p in want]:
            fail(f"mesh: the {label} encode's packets (run {i + 1}) differ "
                 "from the unsharded")
        if label != "mesh":
            continue
        # the analysis's kernels run in every slot's band; the filter
        # stage once a frame, as unsharded
        expected = {k: (MESH_SLOTS if k in ANALYSIS_KERNELS else 1) * v
                    for k, v in runs[0][2].items()}
        if launches != expected:
            fail(f"mesh: launches {launches}, not {expected}: {MESH_SLOTS} x "
                 f"the unsharded analysis kernels' {runs[0][2]} and the "
                 "same filter kernels'")
        if len(bands) != MESH_SLOTS:
            fail(f"mesh: not every slot's bands ran through its runner: "
                 f"{bands}")
    second = runs[2][4]
    if any(b["eager"] or b["captures"] for b in second.values()):
        fail(f"mesh: the second mesh context ran a band key eagerly or "
             f"captured one: {second}")
    import multiprocessing

    # both mesh contexts' packets decode, each in a process of its own,
    # while the GOP channel runs
    with multiprocessing.get_context("spawn").Pool(2) as decoders:
        decoded = decoders.map_async(
            _decode_chunk, [decode_triples(runs[i][1]) for i in (1, 2)])
        t = time.monotonic()
        lines.append(mesh_gop_case(r, clip, card)
                     + f"; {time.monotonic() - t:.3f} s")
        errs = decoded.get(timeout=600)
    if any(errs):
        fail(f"mesh: {[e for e in errs if e]}")
    lines.append(f"{len(want)} packets of each mesh context equal the "
                 "unsharded and decode to their rec; the second mesh "
                 "context only replayed")
    summed = {k: runs[1][2][k] + runs[2][2][k] for k in runs[1][2]}
    return lines, summed


def bench_phase():
    """``python3 bench_torch.py`` (bench.py's workload through the port on
    the card) in a subprocess: its JSON line, after each repetition's
    seconds and runs of the replayed programs, of which the second and
    third repetitions must run no key eagerly and capture none (their
    contexts replay what the warm-up and the first repetition captured)."""
    out = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py")],
                         cwd=ROOT, env=subprocess_env(), capture_output=True,
                         text=True, timeout=600)
    if out.returncode != 0:
        fail(f"bench: exit code {out.returncode}\n{out.stderr[-3000:]}")
    *_, reps_line, line = out.stdout.strip().splitlines()
    result = json.loads(line)
    if not result.get("value", 0) > 0:
        fail(f"bench: no throughput in {line}")
    reps = json.loads(reps_line.removeprefix("repetitions "))
    for i, rep in enumerate(reps):
        print(f"  repetition {i + 1}: {rep}", flush=True)
        if i > 0 and any(rep[k]["eager"] or rep[k]["captures"]
                         for k in ("chain", "analysis", "CDEF")):
            fail(f"bench: repetition {i + 1} ran a key eagerly or captured "
                 f"one: {rep}")
    return line


def guarded(name, failed, fn):
    """fn()'s result; on a failure (its message or traceback printed),
    None with ``name`` added to ``failed``."""
    import traceback

    try:
        return fn()
    except SystemExit:
        pass
    except Exception:
        traceback.print_exc()
    print(f"FAIL: phase {name}", file=sys.stderr, flush=True)
    failed.append(name)
    return None


def main() -> int:
    t0 = time.monotonic()
    try:
        import torch
    except ImportError as e:
        fail(f"PyTorch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    try:
        import rav1e_tpu_torch
        from rav1e_tpu_torch.device import _build, kernels
    except ImportError as e:
        fail(f"rav1e_tpu_torch is not importable next to this script: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    info = gpu_info()
    kind = torch.cuda.get_device_name(0)
    int_ops, sms, mhz = int32_ops_per_s()
    phase("env", t0, f"{info} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | devices {torch.cuda.device_count()} | "
          f"{sms} SMs, max SM clock {mhz:.0f} MHz: {int_ops:.6g} int32 "
          "ops/s")

    t = time.monotonic()
    _build.lib()
    kernels_s = time.monotonic() - t
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip(), flush=True)
    from rav1e_tpu_torch import native

    if native.get_lib() is None:
        fail("the host coder's native library did not build")
    phase("build", t, f"(kernels {kernels_s:.3f} s, then the host coder)")

    t = time.monotonic()
    rng = np.random.default_rng(SEED)
    clip = synth_clip(WIDTH, HEIGHT, NFRAMES, rng)
    phase("clip", t, f"{NFRAMES} frames {WIDTH}x{HEIGHT}")

    t = time.monotonic()
    ksum, routes = kernel_phase(dev, clip, int_ops)
    ROUTE_LAUNCHES.update(routes)
    count_routes()
    phase("kernels", t, "kernel == plain at every shape")

    pkts, launches, spans, _ = encode_phase(rav1e_tpu_torch, clip, True,
                                            "slice")
    n_chain = span_count(spans, "chain_replay_code")
    print(f"  chain: {n_chain} frames coded by the chain, "
          f"{span_count(spans, 'chain_overflow')} overflow and "
          f"{span_count(spans, 'chain_diverged')} divergence fallbacks, "
          f"{span_count(spans, 'chain_predispatch_hit')} predispatch hits",
          flush=True)
    if n_chain < 1:
        fail("slice: no inter frame was coded by the device chain")
    if "jax" in sys.modules:
        fail("jax was imported")

    with tempfile.TemporaryDirectory() as tmp:
        t = time.monotonic()
        cli_report, cli_launches, shown = cli_phase(clip, pkts, tmp)
        # the CLI's encode is the slice's: the same frames down each route
        moved = {k: (cli_launches.get(k), launches[k])
                 for k in FILTER_KERNELS
                 if cli_launches.get(k) != launches[k]}
        if moved:
            fail(f"cli: filter kernel launches (cli, slice) differ: {moved}")
        phase("cli", t, cli_report)

    # the slice's packets, which the CLI's IVF holds byte for byte
    t = time.monotonic()
    verify_decode(pkts, shown)
    phase("decode", t, f"{len(pkts)} packets decode to their rec, and the "
          f"{len(shown)} shown frames to the CLI's reconstruction")
    del shown

    off_pkts, off_launches, off_spans, _ = encode_phase(
        rav1e_tpu_torch, clip[:4], False, "chain-off")
    if span_count(off_spans, "chain_dispatch"):
        fail("chain-off: the chain ran with device_chain=False")
    t = time.monotonic()
    verify_decode(off_pkts)
    phase("chain-off-decode", t, f"{len(off_pkts)} packets decode to their "
          "rec")

    t = time.monotonic()
    for line in chain_phase(clip, dev):
        print("  " + line, flush=True)
    phase("chain-stages", t, "card == CPU for every stage output")

    t = time.monotonic()
    for line in analysis_phase(clip, dev):
        print("  " + line, flush=True)
    phase("analysis", t, "card == CPU up to near-ties")

    t = time.monotonic()
    small = small_clip_phase(rav1e_tpu_torch, dev)
    phase("small-clip", t, small)

    # the last three phases are independent: each runs whether or not the
    # one before it failed, and any failure fails the run at the end
    failed = []

    import multiprocessing

    # the gop phase's decode (a process per chunk) runs on while the capi
    # and configs phases run
    with multiprocessing.get_context("spawn").Pool(
            GOP_FRAMES // GOP_LEN) as decoders:
        t = time.monotonic()
        gop = guarded("gop", failed,
                      lambda: gop_phase(rav1e_tpu_torch, decoders))
        if gop:
            for line in gop[0]:
                print("  " + line, flush=True)
            phase("gop", t, "3 slots == the chunks encoded alone")

        t = time.monotonic()
        report = guarded("capi", failed, capi_phase)
        if report:
            phase("capi", t, report)

        t = time.monotonic()
        lines = guarded("configs", failed,
                        lambda: configs_phase(rav1e_tpu_torch, dev))
        if lines:
            for line in lines:
                print("  " + line, flush=True)
            phase("configs", t, "card == CPU for every configuration")

        t = time.monotonic()
        ref = guarded("reference", failed,
                      lambda: reference_phase(rav1e_tpu_torch, dev))
        if ref:
            phase("reference", t, f"{len(reference_cells.CELLS)} cells, "
                  f"then {len(reference_cells.small_cells())} again through "
                  "the stored runners, == rav1e_tpu's packets on the card, "
                  "and decode")

        if gop:
            t = time.monotonic()
            report = guarded("gop-decode", failed,
                             lambda: gop_decode_check(gop[2]))
            if report:
                phase("gop-decode", t, report)

    t = time.monotonic()
    mesh = guarded("mesh", failed,
                   lambda: mesh_phase(rav1e_tpu_torch, clip, info))
    if mesh:
        for line in mesh[0]:
            print("  " + line, flush=True)
        phase("mesh", t, f"{MESH_SLOTS} slots of the card == unsharded "
              f"({info})")
    t = time.monotonic()
    line = guarded("bench", failed, bench_phase)
    if line:
        phase("bench", t, f"bench_torch.py: {line} ({info})")
    if failed:
        fail(f"phases failed: {failed}")
    gop_launches = gop[1]
    mesh_launches = mesh[1]
    ref_launches = ref[1]
    by_phase = {"slice": launches, "cli": cli_launches,
                "chain-off": off_launches, "gop": gop_launches,
                "mesh": mesh_launches, "reference": ref_launches}
    # the filter kernels' counts each phase checked against its routes
    moved = {k: (v["satd8"], v["grid_search"]) for k, v in by_phase.items()
             if (v["satd8"], v["grid_search"]) != LAUNCHES_BY_PHASE[k]}
    if moved:
        fail(f"launches (satd8, grid_search) moved: {moved}, against "
             f"{LAUNCHES_BY_PHASE}")
    t = time.monotonic()
    from rav1e_tpu_torch.device import graphs

    st = graphs.STORE.stats(dev)
    phase("store", t, f"{st['sets']} sets of replayed programs on the card "
          f"({st['in_use']} in use), pools {st['pool_bytes']} bytes")

    # the PyTorch port imports nothing of the JAX package
    ref_mods = sorted(m for m in sys.modules
                      if m == "rav1e_tpu" or m.startswith("rav1e_tpu."))
    if ref_mods:
        fail(f"modules of rav1e_tpu were imported: {ref_mods}")

    out = {"kernels": []}
    cdef_cu = "rav1e_tpu_torch/csrc/cdef.cu"
    for name, src, rep in (
        ("satd8", "rav1e_tpu_torch/csrc/satd8.cu",
         "rav1e_tpu/device/pallas_kernels.py:150"),
        ("grid_search", "rav1e_tpu_torch/csrc/grid_search.cu",
         "rav1e_tpu/device/pallas_kernels.py:229"),
        ("cdef_dirs", cdef_cu, "rav1e_tpu/device/filters.py:85"),
        ("cdef_search", cdef_cu, "rav1e_tpu/device/filters.py:383"),
        ("cdef_apply", cdef_cu, "rav1e_tpu/device/filters.py:441"),
        ("deblock_edges", "rav1e_tpu_torch/csrc/deblock.cu",
         "rav1e_tpu/device/dsp.py:568"),
        *((k, "rav1e_tpu_torch/csrc/firstpass.cu", None)
          for k in FIRSTPASS_KERNELS),
    ):
        s = ksum[name]
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name],
            "launches_by_phase": {k: v[name] for k, v in by_phase.items()},
            "max_abs_err": s["max_abs_err"],
            "ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
            "library_ms": None, "shape": s["shape"],
        }
        if name in FILTER_KERNELS:
            entry["launches_per_run"] = {r: ROUTE_LAUNCHES[r][name]
                                         for r in ROUTE_LAUNCHES}
            entry["library_note"] = ("no one PyTorch call computes this "
                                     "function")
        if rep is None:
            entry["library_note"] = ("replaces no TPU kernel: the JAX "
                                     "package runs this work on the host")
        out["kernels"].append(entry)
    print(info, flush=True)
    print(json.dumps(out), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
