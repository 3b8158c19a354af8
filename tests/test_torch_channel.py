"""rav1e_tpu_torch's channel API with GOP-parallel slots.

At 48x48 no device stage runs in either package, so the port's 3-slot
channel is held byte for byte against rav1e_tpu's (no JAX compile), in low
latency and pyramid mode.  At 128x64 on the CPU device the port's slots
run its device analysis and chain from three threads at once; their
packets equal each keyframe-aligned chunk encoded alone in a fresh serial
context, with ``input_frameno`` offset by the chunk's start."""

import numpy as np
import pytest

import rav1e_tpu
import rav1e_tpu_torch
from torch_threads import one_torch_cpu_thread  # noqa: F401


def _config(pkg, w, h, kf, slots, low_latency, **kw):
    return pkg.Config(
        enc=pkg.EncoderConfig(
            width=w, height=h, quantizer=120, low_latency=low_latency,
            speed_settings=pkg.SpeedSettings.from_preset(6),
            min_key_frame_interval=kf, max_key_frame_interval=kf,
        ),
        parallel_gops=slots, **kw,
    )


def _clip(w, h, n, seed=5):
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2 + n))
    base = np.repeat(np.repeat(coarse, 8, 0), 8, 1)
    return [[np.clip(base[:ch, 2 * t: 2 * t + cw]
                     + rng.integers(-3, 4, (ch, cw)), 0, 255).astype(np.uint8)
             for ch, cw in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
            for t in range(n)]


def _fill(frame, planes):
    for p, arr in zip(frame.planes, planes):
        p.copy_from(arr[: p.cfg.height, : p.cfg.width])
    return frame


def channel_packets(cfg, clip):
    sender, receiver = cfg.new_channel()
    for planes in clip:
        sender.send(_fill(sender.new_frame(), planes))
    sender.close()
    return list(receiver)


def serial_packets(cfg, clip, pkg):
    ctx = cfg.new_context()
    for planes in clip:
        ctx.send_frame(_fill(ctx.new_frame(), planes))
    ctx.flush()
    pkts = []
    while True:
        try:
            pkts.append(ctx.receive_packet())
        except pkg.EncoderStatus.LimitReached:
            return pkts


@pytest.mark.parametrize("low_latency", [True, False])
def test_gop_parallel_matches_reference(low_latency):
    """11 frames, keyframes every 4: chunks of 4, 4 and 3 frames."""
    clip = _clip(48, 48, 11)
    want = channel_packets(
        _config(rav1e_tpu, 48, 48, 4, 3, low_latency), clip)
    got = channel_packets(
        _config(rav1e_tpu_torch, 48, 48, 4, 3, low_latency, device="cpu"),
        clip)
    assert [p.input_frameno for p in got] == [p.input_frameno for p in want]
    assert [p.data for p in got] == [p.data for p in want]
    keys = [p.input_frameno for p in got
            if p.frame_type == rav1e_tpu_torch.FrameType.KEY]
    assert keys == [0, 4, 8]


def test_gop_parallel_equals_chunks_alone(monkeypatch):
    """128x64, 6 frames, keyframes every 2: three slots run the device
    analysis and chain at once; each chunk's packets are those of the chunk
    encoded alone."""
    from rav1e_tpu_torch.decoder import decode_packet
    from rav1e_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "_enabled", True)
    trace.reset()
    clip = _clip(128, 64, 6, seed=9)
    cfg = _config(rav1e_tpu_torch, 128, 64, 2, 3, False, device="cpu")
    try:
        got = channel_packets(cfg, clip)
        spans = trace.stage_summary()
    finally:
        trace.reset()
    want = []
    for c in range(3):
        alone = _config(rav1e_tpu_torch, 128, 64, 2, 0, False, device="cpu")
        for p in serial_packets(alone, clip[2 * c: 2 * c + 2],
                                rav1e_tpu_torch):
            want.append((p.input_frameno + 2 * c, p.data))
    assert [(p.input_frameno, p.data) for p in got] == want
    # the inter frame of every chunk went to the device chain: replayed, or
    # sent back to the host body by the reference's overflow fallback
    count = {k: spans[k]["count"] if k in spans else 0
             for k in ("chain_dispatch", "chain_replay_code", "chain_overflow",
                       "chain_diverged")}
    assert spans["device_analysis"]["count"] >= 6
    assert count["chain_dispatch"] == 3 and count["chain_replay_code"] >= 1
    assert (count["chain_replay_code"] + count["chain_overflow"]
            + count["chain_diverged"]) == 3
    state = None
    for p in got:
        dec, state = decode_packet(p.data, state)
        for pi, dp in enumerate(dec.planes):
            a = dp.as_array()
            assert np.array_equal(
                a, p.rec.planes[pi].as_array()[: a.shape[0], : a.shape[1]])


def test_worker_stream_only_on_cuda():
    """A GOP worker enters a CUDA stream of its own only on a CUDA device;
    on the CPU it runs as it is."""
    import contextlib

    from rav1e_tpu_torch.api import channel

    cfg = _config(rav1e_tpu_torch, 64, 64, 4, 3, True, device="cpu")
    assert isinstance(channel._worker_stream(cfg), contextlib.nullcontext)
