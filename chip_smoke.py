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
   batch and 12-bit magnitudes, with both timed by CUDA events: satd8 at
   the intra and subpel shapes and at 12-bit diffs whose 64x64 block sums
   reach their bound (4096 * 4095), grid_search at the four full-pel rounds
   that me_field runs on two frames of the clip, on a flat plane (every key
   ties within a seed) and at a ragged n = 37;
4. slice: a 16-frame 1080p 8-bit 4:2:0 encode through the default
   rav1e_tpu_torch.Config() at speed 6 (device "cuda"; device analysis and
   device reconstruction chain on, pyramid reordering); prints the frames
   the chain coded, its overflow and replay-divergence fallbacks and its
   predispatch hits; at least one inter frame is chain-coded, and both
   kernels were launched by the encode; every packet decodes to its
   reconstruction through rav1e_tpu_torch.decoder;
5. chain-off tier: the same preset with device_chain=False over the first
   4 frames (every frame through the host tile coder), with the same
   launch and decode checks;
6. chain stages: the five device-chain stages for one bidirectional inter
   frame of the clip, on the card and on the CPU from identical inputs
   (maps, MV fields, packed aux, reference planes): every output exactly
   equal, plus the selection stage on all-zero MV fields, where candidates
   tie; each stage timed by CUDA events, with its kernel launches and
   device-busy time from torch.profiler;
7. analysis: the port's whole-frame analysis on the card against the same
   analysis on the CPU (plain versions) for a key, a forward-inter and a
   bidirectional frame: MV fields exactly equal, and every differing
   decision cell a near-tie (relative cost gap < 1e-5 on the CPU);
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
   the wall time) and the most CUDA streams busy at once;
11. capi: the port's C shim and example (``rav1e_tpu_torch/capi/``) built
   with g++ and the Python embed flags, run with "cuda" and with "cpu":
   the packet lines must be identical;
12. configs: a 256x128 6-frame clip on the card and on the CPU (in worker
   processes) gives byte-identical packets at reference_cells.py's ten
   configurations (10 and 12 bit, 4:2:2, 4:4:4, 2x2 tiles, low latency,
   speeds 8, 9 and 10, and a ragged clip, here 200x136); then its 4 fuzz
   seeds through ``fuzz_encode_decode`` on the card; prints each
   configuration's chain frames and kernel launches;
13. reference: every cell of reference_cells.py, the
   640x384 16-frame bench clip included, encoded on the card with the
   kernels on gives rav1e_tpu's packets byte for byte (their hashes in
   tests/data/torch_reference_packets.json, made by
   tools/torch_reference_packets.py), and every packet decodes to its
   reconstruction; prints per cell the packets, the chain frames and the
   kernel launches; a differing cell is encoded on the CPU too, to say
   whether the card or the port differs;
14. mesh: ``make_mesh(4, devices=["cuda:0"] * 4)``, four slots of the card,
   each band on a stream of its own: sharded_frame_analysis and
   sharded_inter_analysis on a 1024x1920 frame pair equal the same calls
   on 4 CPU slots (maps and MVs exactly, bits within 1e-5 relative); the
   port's dryrun_multichip on the card's slots; a 4-frame 1080p chain-on
   encode with the pipeline's analysis mesh set to the card's slots gives
   the unsharded encode's packets, which decode; prints both encodes'
   frames/s and kernel launches beside the card's name and power limit;
15. bench: ``python3 bench_torch.py`` (bench.py's workload through the
   port on the card) in a subprocess; prints its JSON line.

The line before the last is the kernels' JSON summary, preceded by
nvidia-smi's name and power limit; the last line is
{"ok": true, "device": {...}}.  Any failure exits non-zero without it.
Each kernel's bound is the larger of its bytes (each input read once, each
output written once) over the H100's 3.35 TB/s and its integer operations
over 67 Tops (the card's non-tensor float32 rate, the nearest published
peak), computed from this run's inputs.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

import reference_cells

ROOT = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT, NFRAMES, QUANTIZER = 1920, 1080, 16, 120
GOP_FRAMES, GOP_LEN, GOP_SLOTS = 48, 16, 3
NEAR_TIE = 1e-5
SEED = 42
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_OPS_PER_S = 67e12  # H100 SXM non-tensor float32 rate
# satd8, per 8x8 cell: 16 eight-point butterflies of 24 add/sub, 64 |.|,
# 64 adds
SATD_OPS_PER_CELL = 16 * 24 + 64 + 64


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


def bound(nbytes: float, ops: float):
    """(least ms the card could take, what bounds it)."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S
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


def kernel_phase(dev, luma0, luma1):
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
    cur = upload_source_luma(luma1, dev).to(torch.int32)
    ref = upload_source_luma(luma0, dev).to(torch.int32)
    rounds = grid_search_rounds(cur, ref)
    names = ["L2 R3 s2", "L2 R1 s1", "L1 R2 s1", "L0 R2 s1"]
    grid_cases = [(f"{nm} n{a[0].shape[0]}", a)
                  for nm, a in zip(names, rounds)]
    flat = torch.full_like(cur, 97)
    for nm, a in zip(names, grid_search_rounds(flat, flat)):
        clip = a[9]
        seeds = [ints(-2 * clip, 2 * clip + 1, tuple(sd.shape))
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
        ms = cuda_ms(lambda: kernels.satd8(d), 20)
        pms = cuda_ms(lambda: kernels.satd8_plain(d), 5)
        cells = d.numel() // 64
        b = bound(4 * (d.numel() + got.numel()), SATD_OPS_PER_CELL * cells)
        rows.append(("satd8", label, err, ms, pms, *b))
    for label, a in grid_cases:
        got = kernels.grid_search(*a)
        want = kernels.grid_search_plain(*a)
        torch.cuda.synchronize()
        err = (int((got - want).abs().max()) if got.shape == want.shape
               else float("inf"))
        if err != 0:
            fail(f"grid_search {label}: kernel != plain (max abs err {err})")
        ms = cuda_ms(lambda: kernels.grid_search(*a), 20)
        pms = cuda_ms(lambda: kernels.grid_search_plain(*a), 5)
        rows.append(("grid_search", label, err, ms, pms,
                     *bound(*grid_search_bound(a))))
    summary = {}
    for name, label, err, ms, pms, bms, by in rows:
        print(f"  {name:11s} {label:24s} max_abs_err={err} kernel_ms={ms:.4f} "
              f"plain_ms={pms:.4f} bound_ms={bms:.4f} ({by}) "
              f"share_of_bound={bms / ms:.3f}", flush=True)
        s = summary.setdefault(name, {"max_abs_err": 0.0})
        s["max_abs_err"] = max(s["max_abs_err"], float(err))
    # the JSON line's times: the largest main-path call of each kernel
    for name, label in (("satd8", "subpel 8160x49x16x16"),
                        ("grid_search", grid_cases[3][0])):
        r = next(r for r in rows if r[0] == name and r[1] == label)
        summary[name].update(ms=r[3], plain_ms=r[4], bound_ms=r[5],
                             bound_by=r[6], shape=label)
    return summary


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


def encode_phase(rav1e_tpu_torch, clip, chain, label):
    """Encode ``clip`` through the preset on the card with the kernels'
    launch counts set to 0 just before and read just after; returns the
    packets, the launch counts and the stage spans."""
    import torch

    from rav1e_tpu_torch.device import kernels
    from rav1e_tpu_torch.utils import trace

    trace.trace_enable()
    trace.reset()
    ctx = slice_config(rav1e_tpu_torch, chain=chain).new_context()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.monotonic()
    pkts = encode(ctx, clip, rav1e_tpu_torch)
    torch.cuda.synchronize()
    enc_s = time.monotonic() - t
    launches = dict(kernels.LAUNCHES)
    spans = trace.stage_summary()
    trace.reset()
    n = len(clip)
    phase(label, t, f"{len(pkts)} packets, {n} frames in {enc_s:.3f} s = "
          f"{n / enc_s:.4f} frames/s at {WIDTH}x{HEIGHT}; launches {launches}")
    for name, s in spans.items():
        print(f"  span {name:22s} count={s['count']} total_ms={s['total_ms']}"
              f" mean_ms={s['mean_ms']}", flush=True)
    coded = sum(1 for p in pkts if p.rec is not None and len(p.data) > 8)
    if coded < 1 or len(pkts) < n:
        fail(f"{label}: {len(pkts)} packets for {n} frames")
    for name, k in launches.items():
        if k <= 0:
            fail(f"{label}: kernel {name} was not launched by the encode")
    if ctx.pipeline.device.type != "cuda":
        fail(f"{label}: the default Config ran on {ctx.pipeline.device}, "
             "not the card")
    return pkts, launches, spans


def span_count(spans, name):
    return spans[name]["count"] if name in spans else 0


# ---------------------------------------------------------------------------
# phase 6: the device-chain stages, card against CPU
# ---------------------------------------------------------------------------

CHAIN_FRAMES = (2, 0, 4, 8)  # the coded frame, then its LAST, ALTREF, BWDREF


def chain_case(clip, dev):
    """Inputs of one bidirectional inter frame for the chain stages: clip
    frame 2 against frames 0, 4 and 8 as its three references, with the
    card's analysis maps at QUANTIZER, no segmentation, and the pipeline's
    deblock levels and CDEF candidate lists.  All host numpy, so both
    devices get the same inputs."""
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
    for i in CHAIN_FRAMES:
        f = Frame.new(WIDTH, HEIGHT, ChromaSampling.Cs420, bd)
        for p, arr in zip(f.planes, clip[i]):
            p.copy_from(arr)
            p.pad()
        frames.append(f)
    q_step = tables.ac_q(qi, 0, bd) / 8.0
    luma = [clip[i][0] for i in CHAIN_FRAMES]
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
        "aux": chain.pack_aux(geom, plan, fields, dcq8, acq8, dbl, y_list,
                              uv_list),
        "src": chain.host_src_planes(frames[0], WIDTH, HEIGHT),
        "refs": [chain.host_pad_planes(f, WIDTH, HEIGHT) for f in frames[1:]],
    }


def chain_calls(case, dev, aux=None):
    """The five stages as (name, call, output names), each call reading the
    outputs of the stages before it from the dict returned with them."""
    import torch

    from rav1e_tpu_torch.device import chain

    f = chain.chain_stages(case["geom"])
    aux = torch.from_numpy(case["aux"] if aux is None else aux).to(dev)
    src = tuple(torch.from_numpy(p).to(dev) for p in case["src"])
    refs = tuple(tuple(torch.from_numpy(p).to(dev) for p in r)
                 for r in case["refs"])
    o = {}
    calls = [
        ("select+luma MC", lambda: f[0](src[0], tuple(r[0] for r in refs),
                                        aux), ("pred_y", "sels")),
        ("chroma MC", lambda: f[1](tuple(r[1] for r in refs),
                                   tuple(r[2] for r in refs), aux, o["sels"]),
         ("pred_u", "pred_v")),
        ("tx+quant+recon", lambda: f[2](src, (o["pred_y"], o["pred_u"],
                                              o["pred_v"]), aux),
         ("levels_flat", "eob_ord", "overflow", "recons", "skip8", "tx8",
          "bsize8")),
        ("deblock+CDEF", lambda: f[3](o["recons"], src, o["skip8"], o["tx8"],
                                      o["bsize8"], aux, case["y_list"],
                                      case["uv_list"]),
         ("ref_out", "cdef_idx")),
        ("pack", lambda: f[4](o["overflow"], o["eob_ord"], o["sels"],
                              o["cdef_idx"], o["levels_flat"]),
         ("hdr", "levels")),
    ]
    for _name, call, keys in calls:
        o.update(zip(keys, call()))
    return o, calls


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


def profile_call(call):
    """(kernel launches, memcpy/memset count, device-busy ms) of one call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    evs = [e for e in prof.events() if e.device_type == cuda]
    copies = sum(1 for e in evs if e.name.startswith(("Memcpy", "Memset")))
    busy, end = 0.0, None
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in evs):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return len(evs) - copies, copies, busy / 1e3


def chain_phase(clip, dev):
    """The five stages on the card and on the CPU from identical inputs:
    every output exactly equal (and on all-zero MV fields, where the
    selection ties between candidates, the selection too); then each stage
    on the card timed and profiled.  Returns the report lines."""
    from rav1e_tpu_torch.device import chain

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
    total = [0.0, 0, 0, 0.0]
    for name, call, _keys in calls:
        ms = cuda_ms(call, 5)
        kern, copies, busy = profile_call(call)
        lines.append(f"stage {name:16s} ms={ms:.3f} launches={kern} "
                     f"copies={copies} device_busy_ms={busy:.3f}")
        for i, v in enumerate((ms, kern, copies, busy)):
            total[i] += v
    lines.append(f"stage {'all five':16s} ms={total[0]:.3f} "
                 f"launches={total[1]} copies={total[2]} "
                 f"device_busy_ms={total[3]:.3f}")
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
    return report


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
    kernels.reset_launches()
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
    for name in ("satd8", "grid_search"):
        if run["launches"].get(name, 0) <= 0:
            fail(f"gop (parallel_gops={slots}): kernel {name} was not "
                 "launched")
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
    lines.append("steps: " + "; ".join(steps))
    return lines, runs[0][1]["launches"], decoded


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
    return pkts, chain, dict(kernels.LAUNCHES)


def _config_case_cpu(i):
    import torch

    import rav1e_tpu_torch

    torch.set_num_threads(2)
    pkts, chain, _ = config_case(rav1e_tpu_torch, i, "cpu")
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
    for label, (pkts, chain, launches), (want, cchain) in zip(
            CONFIGS, card, cpu):
        if [p.data for p in pkts] != want:
            fail(f"configs {label}: card packets differ from the CPU's")
        lines.append(f"{label:18s} {len(pkts)} packets equal card vs CPU; "
                     f"chain frames {chain} (CPU {cchain}); launches "
                     f"{launches}")
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


def reference_phase(r, dev):
    """Every cell of reference_cells.py, the 640x384 16-frame bench clip
    included, encoded on the card with the kernels on: every packet's hash
    equals rav1e_tpu's (the store made by tools/torch_reference_packets.py),
    every packet decodes to its reconstruction through
    rav1e_tpu_torch.decoder, the device analysis ran in every cell, the
    chain in each cell where it runs, satd8 in every cell and grid_search
    in each cell with inter frames, with rav1e_tpu's count of each stage
    span.  Where a cell differs, the same cell
    encoded on the CPU says whether the card or the port differs.  Returns
    the report and the launches summed over the cells."""
    from rav1e_tpu_torch.device import kernels

    with open(STORE) as f:
        store = json.load(f)["cells"]
    missing = [n for n in reference_cells.CELLS if n not in store]
    if missing:
        fail(f"reference: the store has no packets for {missing}")
    lines, bad, total = [], [], {}
    for name, cell in reference_cells.CELLS.items():
        want = store[name]
        if want["settings"] != cell:
            bad.append(f"{name}: the store was made for other settings")
            continue
        t = time.monotonic()
        kernels.reset_launches()
        pkts, _ctx, spans = reference_cells.encode_traced(r, name,
                                                          device=dev)
        launches = dict(kernels.LAUNCHES)
        enc_s = time.monotonic() - t
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        got = [reference_cells.packet_record(p) for p in pkts]
        err = reference_cells.first_difference(got, want["packets"])
        if err:
            cpu, _, _ = reference_cells.encode_traced(r, name, device="cpu")
            cpu_err = reference_cells.first_difference(
                [reference_cells.packet_record(p) for p in cpu],
                want["packets"])
            bad.append(f"{name}: {err}; on the CPU "
                       + (f"the port differs too: {cpu_err}" if cpu_err
                          else "the port gives rav1e_tpu's packets, so "
                          "the card differs"))
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
        lines.append(
            f"{name:24s} {len(pkts)} packets "
            f"{'== rav1e_tpu' if not err else 'DIFFER'}; chain frames "
            f"{spans['chain_replay_code']} (overflow "
            f"{spans['chain_overflow']}, diverged {spans['chain_diverged']}"
            f"); launches {launches}; encode {enc_s:.3f} s, decode "
            f"{time.monotonic() - t:.3f} s")
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


def mesh_encode(r, clip, mesh):
    """The slice's Config over ``clip`` with the analysis mesh swapped for
    ``mesh`` (None: unsharded) for the encode's duration; returns the
    packets, the kernels' launches, the seconds and the context."""
    import torch

    from rav1e_tpu_torch.device import analysis, kernels

    orig = analysis._analysis_mesh
    analysis._analysis_mesh = lambda device: mesh
    try:
        ctx = slice_config(r).new_context()
        torch.cuda.synchronize()
        kernels.reset_launches()
        t = time.monotonic()
        pkts = encode(ctx, clip, r)
        torch.cuda.synchronize()
        return pkts, dict(kernels.LAUNCHES), time.monotonic() - t, ctx
    finally:
        analysis._analysis_mesh = orig


def mesh_phase(r, clip, info):
    """The sharded analysis functions on MESH_SLOTS slots of cuda:0 against
    the same calls on as many CPU slots, the port's dryrun_multichip on the
    card's slots, and a chain-on 1080p encode with the pipeline's mesh set
    to the card's slots against the same encode unsharded."""
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

    sub = clip[:MESH_FRAMES]
    single, l1, s1, _ = mesh_encode(r, sub, None)
    sharded, l4, s4, ctx = mesh_encode(r, sub, card)
    if not any(isinstance(p, ShardedPlane)
               for p in ctx.pipeline._dev_luma_cache.values()):
        fail("mesh: the encode did not shard its analysis")
    for name, k in l4.items():
        if k <= 0:
            fail(f"mesh: kernel {name} was not launched under the mesh")
    if [p.data for p in sharded] != [p.data for p in single]:
        fail("mesh: the sharded encode's packets differ from the unsharded")
    verify_decode(sharded)
    n = len(sub)
    lines.append(f"{n}-frame {WIDTH}x{HEIGHT} chain-on encode, mesh of "
                 f"{MESH_SLOTS} card slots: {n / s4:.4f} frames/s, launches "
                 f"{l4}; unsharded: {n / s1:.4f} frames/s, launches {l1}; "
                 f"{len(sharded)} packets equal and decode ({info})")
    return lines, l4


def bench_phase():
    """``python3 bench_torch.py`` (bench.py's workload through the port on
    the card) in a subprocess: its one JSON line."""
    out = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py")],
                         cwd=ROOT, env=subprocess_env(), capture_output=True,
                         text=True, timeout=600)
    if out.returncode != 0:
        fail(f"bench: exit code {out.returncode}\n{out.stderr[-3000:]}")
    line = out.stdout.strip().splitlines()[-1]
    result = json.loads(line)
    if not result.get("value", 0) > 0:
        fail(f"bench: no throughput in {line}")
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
    phase("env", t0, f"{info} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | devices {torch.cuda.device_count()}")

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
    ksum = kernel_phase(dev, clip[0][0], clip[1][0])
    phase("kernels", t, "kernel == plain at every shape")

    pkts, launches, spans = encode_phase(rav1e_tpu_torch, clip, True, "slice")
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
        phase("cli", t, cli_report)

    # the slice's packets, which the CLI's IVF holds byte for byte
    t = time.monotonic()
    verify_decode(pkts, shown)
    phase("decode", t, f"{len(pkts)} packets decode to their rec, and the "
          f"{len(shown)} shown frames to the CLI's reconstruction")
    del shown

    off_pkts, _, off_spans = encode_phase(rav1e_tpu_torch, clip[:4], False,
                                          "chain-off")
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
            phase("reference", t, f"{len(ref[0])} cells == rav1e_tpu's "
                  "packets on the card, and decode")

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

    # the PyTorch port imports nothing of the JAX package
    ref_mods = sorted(m for m in sys.modules
                      if m == "rav1e_tpu" or m.startswith("rav1e_tpu."))
    if ref_mods:
        fail(f"modules of rav1e_tpu were imported: {ref_mods}")

    out = {"kernels": []}
    for name, src, rep in (
        ("satd8", "rav1e_tpu_torch/csrc/satd8.cu",
         "rav1e_tpu/device/pallas_kernels.py:150"),
        ("grid_search", "rav1e_tpu_torch/csrc/grid_search.cu",
         "rav1e_tpu/device/pallas_kernels.py:229"),
    ):
        s = ksum[name]
        out["kernels"].append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name],
            "launches_by_phase": {"slice": launches[name],
                                  "cli": cli_launches[name],
                                  "gop": gop_launches[name],
                                  "mesh": mesh_launches[name],
                                  "reference": ref_launches[name]},
            "max_abs_err": s["max_abs_err"],
            "ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
            "library_ms": None, "shape": s["shape"],
        })
    print(info, flush=True)
    print(json.dumps(out), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
