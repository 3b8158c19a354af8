"""rav1e_tpu_torch's device chain at speeds 9 and 10 where a frame edge
forces leaves below the partition range: a side whose remainder mod 32 is 1
to 16 makes the 32x32 blocks that cross it split into 16x16 (or 8x8)
leaves, which speed 10's 32x32-only range never asks for itself
(``device/chain.py`` ``edge_leaf_sizes``).  Each encode runs on the CPU
through the chain, every inter frame is coded by it (the ``inter_chain`` and
``inter_host`` counters), and every packet is decoded by the benchmark's
reference decoder (``encbench/reference/av1``) to exactly the encoder's
reconstruction.  No JAX is compiled."""

import numpy as np
import pytest

import native_libs
import rav1e_tpu_torch as r
from encbench.reference.av1.decoder import decode_packet
from rav1e_tpu_torch.device import chain
from rav1e_tpu_torch.utils import trace
from torch_threads import one_torch_cpu_thread  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def coders():
    native_libs.build()
    native_libs.require()


def _clip(w, h, nframes, seed):
    """A textured pan with grain: per frame its (y, u, v) uint8 planes."""
    rng = np.random.default_rng(seed)
    frames = []
    base = [None] * 3
    for t in range(nframes):
        planes = []
        for i, (ph, pw) in enumerate(((h, w), ((h + 1) // 2, (w + 1) // 2),
                                      ((h + 1) // 2, (w + 1) // 2))):
            if base[i] is None:
                coarse = rng.integers(0, 256, (ph // 8 + 2, pw // 8 + 4))
                base[i] = np.repeat(np.repeat(coarse, 8, 0), 8, 1)
            a = base[i][:ph, 2 * t: 2 * t + pw] + rng.integers(-2, 3, (ph, pw))
            planes.append(np.clip(a, 0, 255).astype(np.uint8))
        frames.append(planes)
    return frames


def _encode(w, h, speed, nframes, low_latency=True, seed=7):
    """(packets, inter frames counted by path) of a q-100 encode."""
    ctx = r.Config(enc=r.EncoderConfig(
        width=w, height=h, quantizer=100, low_latency=low_latency,
        speed_settings=r.SpeedSettings.from_preset(speed),
        min_key_frame_interval=0, max_key_frame_interval=999),
        device="cpu").new_context()
    trace.trace_enable()
    trace.reset()
    try:
        for planes in _clip(w, h, nframes, seed):
            f = ctx.new_frame()
            for p, a in zip(f.planes, planes):
                p.copy_from(a)
            ctx.send_frame(f)
        ctx.flush()
        pkts = []
        while True:
            try:
                pkts.append(ctx.receive_packet())
            except r.EncoderStatus.LimitReached:
                break
        counts = trace.stage_summary()
    finally:
        trace.reset()
        trace.trace_disable()
    return pkts, {k: counts.get(k, {"count": 0})["count"]
                  for k in ("inter_chain", "inter_host")}


def _check(pkts, counts):
    """Every inter frame on the chain; every packet decodes to its
    reconstruction.  A show-existing packet repeats the input frame of the
    hidden frame it shows and codes nothing."""
    inter = len({p.input_frameno for p in pkts
                 if p.frame_type == r.FrameType.INTER})
    assert inter > 0
    assert counts == {"inter_chain": inter, "inter_host": 0}
    state = None
    for i, p in enumerate(pkts):
        dec, state = decode_packet(p.data, state)
        for pi, dp in enumerate(dec.planes):
            got = dp.as_array()
            want = p.rec.planes[pi].as_array()[: got.shape[0], : got.shape[1]]
            bad = np.argwhere(got != want)
            assert not bad.size, (
                f"packet {i} (input {p.input_frameno}), plane {pi}: "
                f"{len(bad)} samples differ, first at {tuple(bad[0])}")


@pytest.mark.parametrize("w,h", [(128, 80), (80, 128), (144, 72)])
def test_low_latency_speed10_edges_decode(w, h):
    _check(*_encode(w, h, 10, 3))


def test_ragged_sweep_decodes():
    """Each remainder of a side mod 32 (8, 16, 24) on each axis, at speeds
    9 and 10: one key frame and one inter frame each."""
    for speed in (9, 10):
        for w, h in ((72, 112), (112, 72), (88, 80), (80, 88)):
            _check(*_encode(w, h, speed, 2, seed=w * h + speed))


def test_reordered_speed10_edges_decode():
    """Random access (a pyramid with backward references) at a size whose
    edges force 16x16 leaves both ways."""
    pkts, counts = _encode(144, 80, 10, 5, low_latency=False)
    assert any(not p.show_frame for p in pkts)
    _check(pkts, counts)


@pytest.mark.parametrize("pr", [(3, 6), (4, 5), (5, 5), (4, 4), (6, 6)])
def test_every_plan_leaf_has_a_bucket(pr):
    """At every size from 64 to 200 in steps of 8, over random size maps,
    each leaf size the plan walks is one of the geometry's sizes."""
    rng = np.random.default_rng(sum(pr))
    for w in range(64, 201, 8):
        for h in range(64, 201, 8):
            mi_cols, mi_rows = w // 4, h // 4
            geom = chain.geom_for(w, h, mi_cols, mi_rows, 8, True, False,
                                  False, *pr)
            maps = rng.integers(3, 7, (geom.gh // 8, geom.gw // 8))
            plan = chain.build_plan(maps, mi_cols, mi_rows, *pr, True)
            leaves = {1 << int(s) for s in np.unique(plan.blk_sl)}
            assert leaves <= set(geom.sizes), (w, h, leaves, geom.sizes)
