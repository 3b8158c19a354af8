"""rav1e_tpu_torch end to end with the default speed-6 preset, device chain
on: inter frames go through the port's device reconstruction chain
(rav1e_tpu_torch.device.chain) on device "cpu", the packets are byte for byte
rav1e_tpu's, and every packet decodes to its reconstruction through the
port's decoder.  The helpers here serve tests/test_torch_encode.py's
4-frame encode too.  The encodes here are ``slow``: each costs minutes of the
reference's JAX compiles on one CPU process (about 3 min for the 6-frame
pyramid, whose chain frames take three program variants, 2 for the ragged
136x88 clip, 5 for the 640x384 clip)."""

import os

import numpy as np
import pytest
from torch_threads import one_torch_cpu_thread  # noqa: F401

pytest.importorskip("jax")

import native_libs  # noqa: E402
import rav1e_tpu  # noqa: E402
import rav1e_tpu_torch  # noqa: E402
from rav1e_tpu_torch.decoder import decode_packet  # noqa: E402

# before any test runs: see tests/native_libs.py
native_libs.build()


def encode(pkg, w, h, nframes, q=120, seed=7, **kw):
    """The default speed-6 preset (device chain on) over a seeded panning
    texture, as tests/test_chain_roundtrip.py builds it; each package's
    Config from its own classes."""
    cfg = pkg.Config(
        enc=pkg.EncoderConfig(
            width=w, height=h, quantizer=q, low_latency=False,
            speed_settings=pkg.SpeedSettings.from_preset(6),
            min_key_frame_interval=0, max_key_frame_interval=9999,
        ),
        **kw,
    )
    assert cfg.enc.speed_settings.device_chain
    ctx = cfg.new_context()
    for planes in clip_planes(w, h, nframes, seed):
        f = ctx.new_frame()
        for p, arr in zip(f.planes, planes):
            p.copy_from(arr)
        ctx.send_frame(f)
    ctx.flush()
    pkts = []
    while True:
        try:
            pkts.append(ctx.receive_packet())
        except pkg.EncoderStatus.LimitReached:
            return pkts, ctx


def clip_planes(w, h, nframes, seed=7):
    """The clip of :func:`encode`: per frame, its (y, u, v) uint8 planes
    (4:2:0)."""
    rng = np.random.default_rng(seed)
    base = {}
    frames = []
    for t in range(nframes):
        planes = []
        for i, (ch, cw) in enumerate(((h, w), ((h + 1) // 2, (w + 1) // 2),
                                      ((h + 1) // 2, (w + 1) // 2))):
            if i not in base:
                coarse = rng.integers(
                    0, 256, ((ch + 7) // 8 + 2, (cw + 7) // 8 + 4))
                base[i] = np.repeat(
                    np.repeat(coarse, 8, axis=0), 8, axis=1
                ).astype(np.float64)
            arr = base[i][:ch, t * 2 : t * 2 + cw]
            noise = rng.integers(-2, 3, (ch, cw))
            planes.append(np.clip(arr + noise, 0, 255).astype(np.uint8))
        frames.append(planes)
    return frames


def reference_packets(w, h, nframes):
    """rav1e_tpu's packets, its analysis on one device."""
    from rav1e_tpu.device import analysis as ana

    old = os.environ.get("RAV1E_TPU_NO_SHARD")
    os.environ["RAV1E_TPU_NO_SHARD"] = "1"
    ana._analysis_mesh.cache_clear()
    try:
        return encode(rav1e_tpu, w, h, nframes)[0]
    finally:
        if old is None:
            del os.environ["RAV1E_TPU_NO_SHARD"]
        else:
            os.environ["RAV1E_TPU_NO_SHARD"] = old
        ana._analysis_mesh.cache_clear()


def port_run(w, h, nframes, monkeypatch):
    """The port's packets on device "cpu", its context, and its chain spans
    (the dispatch spans' arguments included)."""
    from rav1e_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "_enabled", True)
    trace.reset()
    try:
        pkts, ctx = encode(rav1e_tpu_torch, w, h, nframes, device="cpu")
        spans = trace.stage_summary()
        dispatches = [e["args"] for e in trace._events
                      if e["name"] == "chain_dispatch"]
    finally:
        trace.reset()
    return pkts, ctx, spans, dispatches


def check_chain_encode(want, got, ctx, spans, dispatches, need_bwd,
                       max_fallbacks=0):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.data == w.data, f"packet {i} differs from rav1e_tpu's"
    state = None
    for i, p in enumerate(got):
        dec, state = decode_packet(p.data, state)
        if p.rec is None or dec is None:
            continue
        for pi, dp in enumerate(dec.planes):
            a = dp.as_array()
            b = p.rec.planes[pi].as_array()[: a.shape[0], : a.shape[1]]
            assert np.array_equal(a, b), f"packet {i} plane {pi}"
    # every inter frame went to the chain: replayed, or sent back to the
    # host body by the reference's own overflow / divergence fallbacks
    count = {k: spans[k]["count"] if k in spans else 0
             for k in ("chain_replay_code", "chain_overflow",
                       "chain_diverged", "chain_dispatch")}
    coded = count["chain_replay_code"]
    inter = sum(1 for p in got
                if p.frame_type.name != "KEY" and len(p.data) > 100)
    assert coded >= 1
    assert coded + count["chain_overflow"] + count["chain_diverged"] == inter
    assert count["chain_dispatch"] >= inter
    assert count["chain_diverged"] <= max_fallbacks
    assert count["chain_overflow"] <= max_fallbacks
    assert any(s is not None for s in ctx.pipeline._chain_slots)
    assert spans["chain_predispatch_hit"]["count"] >= 1
    if need_bwd:
        assert any(d["has_bwd"] for d in dispatches)
        assert any(d["has_bwd2"] for d in dispatches)


@pytest.mark.slow
def test_chain_pyramid_match_reference(monkeypatch):
    """192x128, 6 frames of pyramid: chain frames with neither, one and
    both backward references."""
    want = reference_packets(192, 128, 6)
    got, ctx, spans, dispatches = port_run(192, 128, 6, monkeypatch)
    check_chain_encode(want, got, ctx, spans, dispatches, need_bwd=True)


@pytest.mark.slow
def test_chain_ragged_dims_match_reference(monkeypatch):
    """136x88: the mi extent is not a superblock multiple, so must-split
    chains and edge blocks appear."""
    want = reference_packets(136, 88, 4)
    got, ctx, spans, dispatches = port_run(136, 88, 4, monkeypatch)
    check_chain_encode(want, got, ctx, spans, dispatches, need_bwd=False)


@pytest.mark.slow
def test_bench_clip_matches_reference(monkeypatch):
    """bench.py's clip shape: 640x384, 16 frames, q 120, speed 6, chain on."""
    want = reference_packets(640, 384, 16)
    got, ctx, spans, dispatches = port_run(640, 384, 16, monkeypatch)
    # noisy content at q 120 overflows the levels budget on some frames,
    # which the reference codes through its host body as well
    check_chain_encode(want, got, ctx, spans, dispatches, need_bwd=True,
                       max_fallbacks=4)
