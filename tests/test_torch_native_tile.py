"""rav1e_tpu_torch's Python and native tile coders, port only, at the three
cells of tests/test_native_tile.py's ``test_native_tile_bitstream_parity``
that run the device chain (128x96 4 frames speed 8, 99x75 3 frames speed 6,
128x96 3 frames speed 9; 8-bit 4:2:0, low latency).

With the chain off both coders give the same bytes.  With it on they need
not: the chain's replay is the native coder's, so in a run that turns the
native tile coder off every chain frame's replay diverges and the host body
codes the frame, and the two runs code the inter frames by different
paths.  Both
runs' packets still decode to their reconstructions.  So that test's
failures come from its premise (a chain encode against a host-body encode),
not from a disagreement of the coders."""

import numpy as np
import pytest

import rav1e_tpu_torch as r
import rav1e_tpu_torch.native_tile as native_tile
from rav1e_tpu_torch import native
from rav1e_tpu_torch.decoder import decode_packet
from rav1e_tpu_torch.utils import trace
from torch_threads import one_torch_cpu_thread  # noqa: F401

CASES = [
    # (w, h, frames, speed): chroma 4:2:0, 8 bits, low latency
    (128, 96, 4, 8),
    (99, 75, 3, 6),
    (128, 96, 3, 9),
]


def _encode(w, h, n, speed, chain, force_python, monkeypatch, seed=5):
    """tests/test_native_tile.py's clip and settings through the port on the
    CPU: (packets, the count of each chain span)."""
    ss = r.SpeedSettings.from_preset(speed)
    ss.device_chain = chain
    ctx = r.Config(
        enc=r.EncoderConfig(
            width=w, height=h, quantizer=110, low_latency=True,
            speed_settings=ss, min_key_frame_interval=0,
            max_key_frame_interval=999,
        ),
        device="cpu",
    ).new_context()
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, ((h + 7) // 8 + 2, (w + 7) // 8 + 2))
    base = np.repeat(np.repeat(coarse, 8, 0), 8, 1)[:h, :w].astype(np.int64)
    with monkeypatch.context() as m:
        if force_python:
            m.setattr(native_tile, "encode_tile_native", lambda te: None)
        m.setattr(trace, "_enabled", True)
        trace.reset()
        for t in range(n):
            f = ctx.new_frame()
            for i, p in enumerate(f.planes):
                ch, cw = p.cfg.height, p.cfg.width
                if i == 0:
                    arr = np.roll(base, 2 * t, axis=1)[:ch, :cw] + \
                        rng.integers(-2, 3, (ch, cw))
                else:
                    arr = rng.integers(256 // 3, 2 * 256 // 3, (ch, cw))
                p.copy_from(np.clip(arr, 0, 255).astype(np.uint8))
            ctx.send_frame(f)
        ctx.flush()
        pkts = []
        while True:
            try:
                pkts.append(ctx.receive_packet())
            except r.EncoderStatus.LimitReached:
                break
        spans = trace.stage_summary()
        trace.reset()
    return pkts, {k: spans[k]["count"] if k in spans else 0
                  for k in ("chain_replay_code", "chain_diverged")}


def _assert_decodes(pkts):
    state = None
    for i, p in enumerate(pkts):
        dec, state = decode_packet(p.data, state)
        if p.rec is None or dec is None:
            continue
        for pi, dp in enumerate(dec.planes):
            a = dp.as_array()
            b = p.rec.planes[pi].as_array()[: a.shape[0], : a.shape[1]]
            assert np.array_equal(a, b), f"packet {i} plane {pi}"


@pytest.mark.parametrize("w,h,n,speed", CASES)
def test_python_and_native_coders_agree_with_the_chain_off(
        w, h, n, speed, monkeypatch):
    assert native.get_lib() is not None
    py, _ = _encode(w, h, n, speed, False, True, monkeypatch)
    cc, _ = _encode(w, h, n, speed, False, False, monkeypatch)
    assert len(py) == len(cc) >= n
    for i, (a, b) in enumerate(zip(py, cc)):
        assert a.data == b.data, f"packet {i} differs"
    _assert_decodes(cc)


@pytest.mark.parametrize("w,h,n,speed", CASES)
def test_chain_on_runs_of_both_coders_decode(w, h, n, speed, monkeypatch):
    assert native.get_lib() is not None
    py, py_spans = _encode(w, h, n, speed, True, True, monkeypatch)
    cc, cc_spans = _encode(w, h, n, speed, True, False, monkeypatch)
    # the native run replays its chain frames; in the Python run every
    # chain frame's replay diverges, and the host body codes it
    assert cc_spans["chain_replay_code"] >= 1
    assert cc_spans["chain_diverged"] == 0
    assert py_spans["chain_diverged"] == py_spans["chain_replay_code"] >= 1
    _assert_decodes(py)
    _assert_decodes(cc)
