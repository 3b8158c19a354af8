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
   the intra and subpel shapes, grid_search at the four full-pel rounds
   that me_field runs on two frames of the clip, on a flat plane (every key
   ties within a seed) and at a ragged n = 37;
4. slice: a 16-frame 1080p 8-bit 4:2:0 encode at speed 6 (device analysis
   on, device chain off) through rav1e_tpu_torch.Config() (device "cuda");
   every packet decodes to its reconstruction through
   rav1e_tpu_torch.decoder; both kernels were launched by the encode;
5. analysis: the port's whole-frame analysis on the card against the same
   analysis on the CPU (plain versions) for a key, a forward-inter and a
   bidirectional frame: MV fields exactly equal, and every differing
   decision cell a near-tie (relative cost gap < 1e-5 on the CPU);
6. small clip: a 256x128 6-frame encode on the card and on the CPU gives
   byte-identical packets.

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
import subprocess
import sys
import time

import numpy as np

WIDTH, HEIGHT, NFRAMES, QUANTIZER = 1920, 1080, 16, 120
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
        d = ints(-mag, mag + 1, shape)
        got = kernels.satd8(d)
        want = kernels.satd8_plain(d)
        torch.cuda.synchronize()
        err = (float((got - want).abs().max()) if got.shape == want.shape
               else float("inf"))
        if err != 0:
            fail(f"satd8 {label}: kernel != plain (max abs err {err})")
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


def synth_clip(w, h, n, rng):
    """bench.py's seeded synthetic pan: a blurred coarse texture panning 2 px
    a frame, with per-frame noise; per-plane uint8 arrays."""
    scene = {}
    frames = []
    for t in range(n):
        planes = []
        for i, (ch, cw) in enumerate(((h, w), ((h + 1) // 2, (w + 1) // 2),
                                      ((h + 1) // 2, (w + 1) // 2))):
            if i not in scene:
                coarse = rng.integers(0, 256, ((ch + 7) // 8 + 1,
                                               (cw + 7) // 8 + 1))
                up = np.repeat(np.repeat(coarse, 8, axis=0), 8,
                               axis=1).astype(np.float64)
                k = np.ones(9) / 9.0
                up = np.apply_along_axis(lambda r: np.convolve(r, k, "same"),
                                         1, up)
                up = np.apply_along_axis(lambda c: np.convolve(c, k, "same"),
                                         0, up)
                scene[i] = up[:ch, :cw]
            arr = np.roll(scene[i], t * 2, axis=1)
            noise = rng.integers(-2, 3, (ch, cw))
            planes.append(np.clip(arr + noise, 0, 255).astype(np.uint8))
        frames.append(planes)
    return frames


def slice_config(rav1e_tpu_torch, device=None, width=WIDTH, height=HEIGHT):
    """The slice's Config; no device means the port's default, the card."""
    ss = rav1e_tpu_torch.SpeedSettings.from_preset(6)
    ss.device_chain = False
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


def verify_decode(pkts):
    from rav1e_tpu_torch.decoder import decode_packet

    state = None
    for i, p in enumerate(pkts):
        dec, state = decode_packet(p.data, state)
        if p.rec is None:
            continue
        for pi, dp in enumerate(dec.planes):
            a = dp.as_array()
            b = p.rec.planes[pi].as_array()[: a.shape[0], : a.shape[1]]
            if not np.array_equal(a, b):
                fail(f"packet {i} plane {pi} does not decode to its rec")


# ---------------------------------------------------------------------------
# phase 5: whole-frame analysis, card against CPU
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
    """A 256x128 6-frame clip through the same slice on the card and on the
    CPU (plain versions): the packets must be byte-identical (the CPU path is
    the one tests/test_torch_encode.py holds byte-identical to rav1e_tpu)."""
    w, h = 256, 128
    clip = synth_clip(w, h, 6, np.random.default_rng(SEED))
    got = {d: encode(slice_config(rav1e_tpu_torch, d, w, h).new_context(),
                     clip, rav1e_tpu_torch)
           for d in (dev, "cpu")}
    a, b = got[dev], got["cpu"]
    if len(a) != len(b) or any(x.data != y.data for x, y in zip(a, b)):
        fail("small clip: packets on the card differ from the CPU's")
    return f"{len(a)} packets byte-identical card vs CPU"


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

    from rav1e_tpu_torch.utils import trace

    trace.trace_enable()
    trace.reset()
    ctx = slice_config(rav1e_tpu_torch).new_context()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.monotonic()
    pkts = encode(ctx, clip, rav1e_tpu_torch)
    torch.cuda.synchronize()
    enc_s = time.monotonic() - t
    launches = dict(kernels.LAUNCHES)
    spans = trace.stage_summary()
    coded = sum(1 for p in pkts if p.rec is not None and len(p.data) > 8)
    phase("slice", t, f"{len(pkts)} packets, {NFRAMES} frames in "
          f"{enc_s:.3f} s = {NFRAMES / enc_s:.4f} frames/s at "
          f"{WIDTH}x{HEIGHT} on {info}; launches {launches}")
    for name in ("device_analysis", "cdef_rdo_device", "encode_tiles",
                 "lrf_decide", "deblock", "deblock_search"):
        if name in spans:
            s = spans[name]
            print(f"  span {name:16s} count={s['count']} "
                  f"total_ms={s['total_ms']} mean_ms={s['mean_ms']}",
                  flush=True)
    if coded < 1 or len(pkts) < NFRAMES:
        fail(f"encode produced {len(pkts)} packets for {NFRAMES} frames")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched by the encode")
    if "jax" in sys.modules:
        fail("jax was imported")
    if ctx.pipeline.device.type != "cuda":
        fail(f"the default Config ran on {ctx.pipeline.device}, not the card")

    t = time.monotonic()
    verify_decode(pkts)
    phase("decode", t, f"{len(pkts)} packets decode to their rec")

    t = time.monotonic()
    for line in analysis_phase(clip, dev):
        print("  " + line, flush=True)
    phase("analysis", t, "card == CPU up to near-ties")

    t = time.monotonic()
    small = small_clip_phase(rav1e_tpu_torch, dev)
    phase("small-clip", t, small)

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
            "launches": launches[name], "max_abs_err": s["max_abs_err"],
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
