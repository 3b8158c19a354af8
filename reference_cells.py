"""The cells at which rav1e_tpu_torch is held against rav1e_tpu's packets.

One definition, numpy only, read by the store's generator
(``tools/torch_reference_packets.py``), its tier-1 test
(``tests/test_torch_reference_packets.py``), chip_smoke.py's ``reference``
and ``configs`` phases and ``bench_torch.py``.  It imports neither package
nor JAX: the functions that encode take the package (``rav1e_tpu`` or
``rav1e_tpu_torch``) as an argument and build everything from its own
classes, since an object of one never equals its twin in the other.

A cell is a dict:

- ``kind``: ``"synth"`` (bench.py's seeded pan, as chip_smoke.py's
  configurations draw it), ``"golden"`` (the clip of
  tests/test_golden_bitstream.py), ``"fuzz"`` (a seed of
  ``utils/fuzzing.fuzz_encode_decode``, drawn through each package's own
  ``_rand_config``/``_rand_frames``) or ``"bench"`` (the frames of
  bench.py's first timed repetition);
- ``width``, ``height``, ``frames``, ``seed``, ``speed``, ``quantizer``;
- ``enc``: further ``EncoderConfig`` fields (a chroma sampling by name);
- ``speed_fields``: ``SpeedSettings`` fields set after the preset;
- ``small``: encoded by the tier-1 test on the CPU (every cell but the
  bench clip);
- ``chain``: whether inter frames take the device chain, as on the card;
- ``why``: the reason for its size.

Sizes: each configuration runs at the smallest size where its device stages
run as they do on the card: at least 64 pixels a side (below that the
pipeline skips the device analysis and the chain), at least 4 frames (a key
frame, then forward and bidirectional inter frames of the pyramid).
"""

from __future__ import annotations

import importlib

import numpy as np

SYNTH_SEED = 42  # chip_smoke.py's SEED; configuration i draws SYNTH_SEED + i
QUANTIZER = 120  # bench.py's and chip_smoke.py's
MIN_SIDE = "at least 64 pixels a side: the smallest frame the device " \
    "analysis and the chain take"


def _synth(i, name, why, width=64, height=64, frames=4, speed=6, **enc):
    return name, {
        "kind": "synth", "width": width, "height": height, "frames": frames,
        "seed": SYNTH_SEED + i, "speed": speed, "quantizer": QUANTIZER,
        "enc": enc, "speed_fields": {}, "small": True, "why": why,
    }


# chip_smoke.py's ten configurations, in its order (the seed follows it)
_SYNTH = [
    _synth(0, "10-bit 4:2:0 s6", MIN_SIDE + "; the chain-off tier at 10 "
           "bits", bit_depth=10),
    _synth(1, "12-bit 4:2:0 s6", MIN_SIDE + "; the chain-off tier at 12 "
           "bits", bit_depth=12),
    _synth(2, "8-bit 4:2:2 s6", MIN_SIDE + "; the chain-off tier with "
           "4:2:2 chroma", chroma_sampling="Cs422"),
    _synth(3, "8-bit 4:4:4 s6", MIN_SIDE + "; the chain-off tier with "
           "4:4:4 chroma", chroma_sampling="Cs444"),
    _synth(4, "2x2 tiles s6", "128x128: two superblocks each way, so each "
           "of the 2x2 tiles holds one",
           width=128, height=128, tile_cols=2, tile_rows=2),
    _synth(5, "low latency s6", MIN_SIDE + "; the chain codes each inter "
           "frame against the frame before it", low_latency=True),
    _synth(6, "speed 8", MIN_SIDE + "; the chain at speed 8", speed=8),
    _synth(7, "speed 9", MIN_SIDE + "; the chain at speed 9, whose plan "
           "splits each inter block's transform (tx_split)", speed=9),
    _synth(8, "speed 10", MIN_SIDE + "; the chain at speed 10 (32x32 "
           "blocks, no subpel SATD)", speed=10),
    _synth(9, "ragged 200x136 s6", "100x76: a multiple of 64 neither way "
           "(nor of 8), so the chain meets edge blocks and must-split "
           "partitions, as chip_smoke.py's 200x136 does", width=100,
           height=76),
]


def _golden(name, speed, why, **enc):
    return name, {
        "kind": "golden", "width": 128, "height": 128, "frames": 5,
        "seed": 77, "speed": speed, "quantizer": 115, "enc": enc,
        "speed_fields": {"device_analysis": True, "device_chain": False},
        "small": True, "why": why,
    }


_GOLDEN_WHY = ("tests/test_golden_bitstream.py's clip and settings as they "
               "stand (128x128, 5 frames, q 115)")


def _fuzz(seed, what):
    return f"fuzz seed {seed}", {
        "kind": "fuzz", "seed": seed, "small": True,
        "why": f"{what}: the size, frames and settings the seed draws",
    }


CELLS = dict(
    _SYNTH
    + [_golden("golden s8-device", 8, _GOLDEN_WHY + ": a device cell whose "
               "pin went stale"),
       _golden("golden s6-device-10bit", 6, _GOLDEN_WHY + ": a device "
               "cell whose pin went stale", bit_depth=10),
       _golden("golden s6-device-422", 6, _GOLDEN_WHY + " at 4:2:2: its "
               "8x8 blocks make the CDEF search filter, which bench.py's "
               "pan never does, so the chain-off tier's chroma CDEF "
               "geometry is held", chroma_sampling="Cs422")]
    + [_fuzz(4, "12-bit 4:4:4"), _fuzz(5, "8-bit monochrome"),
       _fuzz(6, "10-bit 4:2:2 with two tile rows"),
       _fuzz(10, "8-bit 4:2:0 at 127x123")]
    + [("bench clip", {
        "kind": "bench", "width": 640, "height": 384, "frames": 16,
        "warm_frames": 6, "seed": 42, "speed": 6, "quantizer": 120,
        "enc": {}, "speed_fields": {}, "small": False,
        "why": "bench.py's workload: 640x384, 16 frames, q 120, the default "
               "preset, drawn after its 6-frame warm-up from default_rng(42)",
    })]
)

# the cells whose inter frames the chain codes on the card (chip_smoke.py's
# configs phase): speeds 8, 9 and 10, low latency, the ragged clip and the
# bench clip (a fuzz seed draws every frame anew: all are key frames)
CHAIN_CELLS = ("low latency s6", "speed 8", "speed 9", "speed 10",
               "ragged 200x136 s6", "bench clip")
for _name, _cell in CELLS.items():
    _cell["chain"] = _name in CHAIN_CELLS


def small_cells():
    return [n for n, c in CELLS.items() if c["small"]]


def pan_runs(w, h, runs, rng, xdec=1, ydec=1, bd=8):
    """bench.py's seeded synthetic pan: a blurred coarse texture panning 2 px
    a frame, with per-frame noise; per frame its planes, uint8 (uint16
    scaled to ``bd`` above 8 bits), chroma decimated by ``xdec``/``ydec``.
    One list of frames per entry of ``runs`` (its frame count), all drawn
    from ``rng`` in turn over one texture, the pan restarting with each run,
    as bench.py's warm-up and timed runs draw theirs."""
    scene = {}
    cw_, ch_ = (w + xdec) >> xdec, (h + ydec) >> ydec
    out = []
    for n in runs:
        frames = []
        for t in range(n):
            planes = []
            for i, (ch, cw) in enumerate(((h, w), (ch_, cw_), (ch_, cw_))):
                if i not in scene:
                    coarse = rng.integers(0, 256, ((ch + 7) // 8 + 1,
                                                   (cw + 7) // 8 + 1))
                    up = np.repeat(np.repeat(coarse, 8, axis=0), 8,
                                   axis=1).astype(np.float64)
                    k = np.ones(9) / 9.0
                    up = np.apply_along_axis(
                        lambda r: np.convolve(r, k, "same"), 1, up)
                    up = np.apply_along_axis(
                        lambda c: np.convolve(c, k, "same"), 0, up)
                    scene[i] = up[:ch, :cw]
                arr = np.roll(scene[i], t * 2, axis=1)
                noise = rng.integers(-2, 3, (ch, cw))
                px = np.clip(arr + noise, 0, 255).astype(np.uint8)
                planes.append(px.astype(np.uint16) << (bd - 8) if bd > 8
                              else px)
            frames.append(planes)
        out.append(frames)
    return out


def golden_clip(w, h, n, seed, xdec=1, ydec=1, bd=8):
    """tests/test_golden_bitstream.py's clip: a panning 8x8-block luma
    texture and flat chroma, each with per-frame noise."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2))
    base = np.repeat(np.repeat(coarse, 8, 0), 8, 1)[:h, :w].astype(np.int64)
    cw, ch = (w + xdec) >> xdec, (h + ydec) >> ydec
    dt = np.uint8 if bd == 8 else np.uint16
    frames = []
    for t in range(n):
        planes = []
        for i, (ph, pw) in enumerate(((h, w), (ch, cw), (ch, cw))):
            if i == 0:
                arr = np.roll(base, 2 * t, axis=1) + rng.integers(-2, 3,
                                                                 (ph, pw))
            else:
                arr = np.full((ph, pw), 128) + rng.integers(-2, 3, (ph, pw))
            arr = np.clip(arr, 0, 255).astype(np.int64) << (bd - 8)
            planes.append(arr.astype(dt))
        frames.append(planes)
    return frames


def encoder_config(pkg, cell):
    """The cell's EncoderConfig, from ``pkg``'s own classes (not for fuzz
    cells, whose configuration the seed draws)."""
    ss = pkg.SpeedSettings.from_preset(cell["speed"])
    for k, v in cell["speed_fields"].items():
        setattr(ss, k, v)
    enc = dict(cell["enc"])
    if "chroma_sampling" in enc:
        enc["chroma_sampling"] = pkg.ChromaSampling[enc["chroma_sampling"]]
    max_key = 999 if cell["kind"] == "golden" else 9999
    return pkg.EncoderConfig(
        width=cell["width"], height=cell["height"],
        quantizer=cell["quantizer"], speed_settings=ss,
        min_key_frame_interval=0, max_key_frame_interval=max_key,
        **{"low_latency": False, **enc})


def clip(cell, enc):
    """The cell's frames (not for fuzz cells) for its EncoderConfig."""
    xdec, ydec = enc.chroma_sampling.decimation()
    w, h, n = cell["width"], cell["height"], cell["frames"]
    if cell["kind"] == "golden":
        return golden_clip(w, h, n, cell["seed"], xdec, ydec, enc.bit_depth)
    warm = cell.get("warm_frames", 0)
    return pan_runs(w, h, [warm, n], np.random.default_rng(cell["seed"]),
                    xdec, ydec, enc.bit_depth)[1]


def drain(ctx, pkg):
    """Flush ``ctx`` and return all its packets."""
    ctx.flush()
    pkts = []
    while True:
        try:
            pkts.append(ctx.receive_packet())
        except pkg.EncoderStatus.LimitReached:
            return pkts


def new_context(pkg, name, **config_kw):
    """(context, frames to send) of cell ``name`` through ``pkg``'s
    ``Config``; ``config_kw`` goes to ``Config`` (the port's ``device``).
    A fuzz cell's frames are the package's ``Frame`` objects."""
    cell = CELLS[name]
    if cell["kind"] == "fuzz":
        fz = importlib.import_module(pkg.__name__ + ".utils.fuzzing")
        rng = np.random.default_rng(cell["seed"])
        ctx = fz._rand_config(rng, valid=True, **config_kw).new_context()
        n = int(rng.integers(1, 5))
        return ctx, list(fz._rand_frames(ctx, rng, n))
    enc = encoder_config(pkg, cell)
    ctx = pkg.Config(enc=enc, **config_kw).new_context()
    return ctx, clip(cell, enc)


def send(ctx, pkg, frame):
    """Send one frame (a Frame or its planes); False when the context takes
    no more (a still picture after its one frame)."""
    if not isinstance(frame, list):
        f = frame
    else:
        f = ctx.new_frame()
        for p, arr in zip(f.planes, frame):
            p.copy_from(arr)
    try:
        ctx.send_frame(f)
    except pkg.EncoderStatus.EnoughData:
        return False
    return True


def encode(pkg, name, **config_kw):
    """Cell ``name`` encoded through ``pkg``: (packets, context)."""
    ctx, frames = new_context(pkg, name, **config_kw)
    for f in frames:
        if not send(ctx, pkg, f):
            break
    return drain(ctx, pkg), ctx


# the pipeline's spans that say which device stages an encode ran
STAGE_SPANS = ("device_analysis", "cdef_rdo_device", "chain_replay_code",
               "chain_overflow", "chain_diverged")


def encode_traced(pkg, name, **config_kw):
    """:func:`encode` with ``pkg``'s stage trace on: (packets, context,
    the count of each of STAGE_SPANS)."""
    trace = importlib.import_module(pkg.__name__ + ".utils.trace")
    was = trace._enabled
    trace._enabled = True
    trace.reset()
    try:
        pkts, ctx = encode(pkg, name, **config_kw)
        spans = trace.stage_summary()
    finally:
        trace.reset()
        trace._enabled = was
    return pkts, ctx, {k: spans[k]["count"] if k in spans else 0
                       for k in STAGE_SPANS}


def packet_record(pkt):
    """What the store keeps of a packet."""
    import hashlib

    return {"len": len(pkt.data), "frame_type": pkt.frame_type.name,
            "sha256": hashlib.sha256(pkt.data).hexdigest()}


def first_difference(got, want):
    """The first packet whose record (:func:`packet_record`) differs from
    rav1e_tpu's, named with its frame type; None when all are equal."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            return (f"packet {i} ({w['frame_type']}) differs from rav1e_tpu's:"
                    f" {g['len']} bytes against {w['len']}")
    if len(got) != len(want):
        return f"{len(got)} packets against rav1e_tpu's {len(want)}"
    return None
