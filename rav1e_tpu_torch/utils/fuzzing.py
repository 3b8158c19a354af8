"""Fuzz harness (reference fuzz/fuzz_targets/* + src/fuzzing.rs).

Three targets, each driven from a seeded RNG (the ``Arbitrary`` analog):

- ``fuzz_construct_context``: random (frequently nonsensical) configs must
  either validate cleanly or raise :class:`InvalidConfig` — never crash.
- ``fuzz_encode``: random valid config + random frames encode without error.
- ``fuzz_encode_decode``: every produced packet must decode with the bundled
  decoder and match the encoder reconstruction bit-exactly (the dav1d-parity
  analog of fuzz_encode_decode in the reference).

Run standalone for longer campaigns:
    python -m rav1e_tpu_torch.utils.fuzzing 200 [--target encode_decode]

The PyTorch port's copy adds ``device``: each target's configs run on the
torch device given (``--device`` on the command line), ``Config``'s default,
the card, unless the caller asks for ``"cpu"``.
"""

from __future__ import annotations

import numpy as np


def _rand_config(rng, valid: bool, device=None):
    from rav1e_tpu_torch import ChromaSampling, Config, EncoderConfig, SpeedSettings

    if valid:
        w = int(rng.integers(16, 160))
        h = int(rng.integers(16, 128))
        bd = int(rng.choice([8, 10, 12]))
        cs = ChromaSampling(int(rng.choice([0, 1, 2, 3])))
        speed = int(rng.integers(3, 11))
        q = int(rng.integers(40, 250))
        bitrate = int(rng.choice([0, 0, 0, 200_000]))
    else:
        w = int(rng.integers(0, 70000))
        h = int(rng.integers(0, 70000))
        bd = int(rng.choice([0, 7, 8, 9, 10, 12, 16]))
        cs = ChromaSampling(int(rng.integers(0, 4)))
        speed = int(rng.integers(0, 11))
        q = int(rng.integers(0, 500))
        bitrate = int(rng.integers(-10_000, 10_000_000))
    enc = EncoderConfig(
        width=w, height=h, bit_depth=bd, chroma_sampling=cs,
        quantizer=min(q, 255) if valid else q,
        bitrate=bitrate,
        low_latency=bool(rng.integers(0, 2)),
        still_picture=bool(rng.integers(0, 8) == 0),
        speed_settings=SpeedSettings.from_preset(speed),
        min_key_frame_interval=0,
        max_key_frame_interval=int(rng.integers(1, 30)),
        tile_cols=int(rng.choice([0, 0, 1, 2])),
        tile_rows=int(rng.choice([0, 0, 1, 2])),
        error_resilient=bool(rng.integers(0, 4) == 0),
    )
    if not valid:
        enc.level_idx = int(rng.choice([0, 4, 8, 31, 31]))
    return Config(enc=enc, **({} if device is None else {"device": device}))


def fuzz_construct_context(seed: int, device=None) -> bool:
    """Returns True when the config constructed, False when it was rejected
    with InvalidConfig.  Any other exception is a fuzz failure."""
    from rav1e_tpu_torch.config import InvalidConfig

    rng = np.random.default_rng(seed)
    cfg = _rand_config(rng, valid=bool(rng.integers(0, 2)), device=device)
    try:
        cfg.new_context()
        return True
    except InvalidConfig:
        return False


def _rand_frames(ctx, rng, n):
    hi = 1 << ctx.config.enc.bit_depth
    dt = np.uint8 if hi <= 256 else np.uint16
    for _ in range(n):
        f = ctx.new_frame()
        for p in f.planes:
            style = int(rng.integers(0, 3))
            ch, cw = p.cfg.height, p.cfg.width
            if style == 0:
                arr = rng.integers(0, hi, (ch, cw))
            elif style == 1:
                arr = np.full((ch, cw), int(rng.integers(0, hi)))
            else:
                arr = np.add.outer(
                    np.arange(ch) * int(rng.integers(1, 5)),
                    np.arange(cw),
                ) % hi
            p.copy_from(arr.astype(dt))
        yield f


def fuzz_encode(seed: int, device=None) -> int:
    """Encode a random clip; returns total bytes (crash = fuzz failure)."""
    from rav1e_tpu_torch import EncoderStatus
    from rav1e_tpu_torch.config import InvalidConfig

    rng = np.random.default_rng(seed)
    try:
        ctx = _rand_config(rng, valid=True, device=device).new_context()
    except InvalidConfig:
        return 0
    n = int(rng.integers(1, 5))
    for f in _rand_frames(ctx, rng, n):
        try:
            ctx.send_frame(f)
        except EncoderStatus.EnoughData:
            break  # legitimate: e.g. still_picture accepts one frame
    ctx.flush()
    total = 0
    while True:
        try:
            total += len(ctx.receive_packet().data)
        except EncoderStatus.LimitReached:
            break
    return total


def fuzz_encode_decode(seed: int, device=None) -> int:
    """Encode + decode + reconstruction parity. Returns packets checked."""
    from rav1e_tpu_torch import EncoderStatus
    from rav1e_tpu_torch.config import InvalidConfig
    from rav1e_tpu_torch.decoder import decode_packet

    rng = np.random.default_rng(seed)
    try:
        ctx = _rand_config(rng, valid=True, device=device).new_context()
    except InvalidConfig:
        return 0
    n = int(rng.integers(1, 5))
    for f in _rand_frames(ctx, rng, n):
        try:
            ctx.send_frame(f)
        except EncoderStatus.EnoughData:
            break  # legitimate: e.g. still_picture accepts one frame
    ctx.flush()
    pkts = []
    while True:
        try:
            pkts.append(ctx.receive_packet())
        except EncoderStatus.LimitReached:
            break
    state = None
    checked = 0
    for p in pkts:
        dec, state = decode_packet(p.data, state)
        if p.rec is not None:
            for pi, dp in enumerate(dec.planes):
                a = dp.as_array()
                b = p.rec.planes[pi].as_array()
                assert np.array_equal(a, b[: a.shape[0], : a.shape[1]]), (
                    f"seed {seed}: recon mismatch plane {pi}"
                )
            checked += 1
    return checked


TARGETS = {
    "construct_context": fuzz_construct_context,
    "encode": fuzz_encode,
    "encode_decode": fuzz_encode_decode,
}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("iterations", type=int, nargs="?", default=50)
    ap.add_argument("--target", choices=sorted(TARGETS), default="encode_decode")
    ap.add_argument("--seed0", type=int, default=0)
    ap.add_argument("--device", help="torch device: cuda (the default), "
                    "cuda:N or cpu")
    args = ap.parse_args(argv)
    fn = TARGETS[args.target]
    for i in range(args.iterations):
        seed = args.seed0 + i
        r = fn(seed, args.device)
        print(f"seed {seed}: ok ({r})")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
