"""The check that decides ``correct``: it passes a sound run, and fails the
control and each fault the cells can have, planted where the program
produces its output."""

import numpy as np
import pytest

from encbench import check
from encbench.tests.conftest import tiny_run


class Broken:
    """The program's context with one fault planted in what
    ``receive_packet`` hands back."""

    def __init__(self, ctx, fault):
        self._ctx, self.fault, self.n, self.prev = ctx, fault, 0, None

    def __getattr__(self, k):
        return getattr(self._ctx, k)

    def receive_packet(self):
        p = self._ctx.receive_packet()
        self.n += 1
        if self.fault == "half" and self.n % 2 == 0:
            # every other packet left out
            p = self._ctx.receive_packet()
        elif self.fault == "token" and self.n == 3:
            # a byte of the third packet altered where it is produced
            d = bytearray(p.data)
            d[len(d) // 2] ^= 0x5A
            p.data = bytes(d)
        elif self.fault == "state" and self.prev is not None and \
                p.show_frame:
            # a step that returns its state unchanged: the last picture
            # handed back again
            p.rec = self.prev
        if p.show_frame:
            self.prev = p.rec
        return p


@pytest.fixture(scope="module")
def sound():
    return tiny_run("ra1080.vod", seconds=2.0)


def test_a_sound_run_is_correct(sound):
    result, lines = sound
    assert result["correct"] and result["failed"] == 0
    assert list(result["checks"]) == ["undecodable", "mismatched_samples",
                                      "order_errors"]
    assert lines == [f"check {k} 0 limit 0" for k in result["checks"]]


@pytest.mark.parametrize("fault", ["token", "state", "half"])
def test_a_planted_fault_is_not_correct(fault, monkeypatch):
    from encbench import harness

    # a hidden frame whose showing packet was left out is waited for this
    # long past the window (a minute in a real run)
    monkeypatch.setattr(harness.Stream, "GRACE_S", 3.0)
    result, _ = tiny_run("ra1080.vod", seconds=2.0,
                         breakage=lambda ctx: Broken(ctx, fault))
    assert not result["correct"], result
    assert result["failed"] > 0


def _packets(n=4, w=64, h=48):
    """A tiny stream of the port's packets and reconstructions."""
    import rav1e_tpu_torch as r

    enc = r.EncoderConfig(width=w, height=h, quantizer=100,
                          speed_settings=r.SpeedSettings.from_preset(6))
    ctx = r.Config(enc=enc, device="cpu").new_context()
    rng = np.random.default_rng(3)
    base = rng.integers(0, 256, (h, w))
    for i in range(n):
        f = ctx.new_frame()
        y = np.clip(np.roll(base, i, axis=1), 0, 255).astype(np.uint8)
        for p, a in zip(f.planes, [y, y[::2, ::2], y[1::2, 1::2]]):
            p.copy_from(np.ascontiguousarray(a))
        ctx.send_frame(f)
    ctx.flush()
    pkts = []
    while True:
        try:
            pkts.append(ctx.receive_packet())
        except r.EncoderStatus.LimitReached:
            break
    return [(p.data, [q.as_array().copy() for q in p.rec.planes],
             p.frame_type.name == "KEY") for p in pkts], pkts


def test_one_sample_changed_fails():
    packets, pkts = _packets()
    shown = [p.input_frameno for p in pkts if p.show_frame]
    hidden = [p.input_frameno for p in pkts if not p.show_frame]
    checks, _ = check.run_check(packets, shown, hidden, workers=1)
    assert check.passed(checks)
    packets[-1][1][0][5, 7] ^= 1
    checks, _ = check.run_check(packets, shown, hidden, workers=1)
    assert checks["mismatched_samples"]["value"] == 1
    assert not check.passed(checks)


def test_the_control_fails():
    """The reconstruction one bit below the configuration's precision, in
    the program's place: the check fails it, in a whole run too."""
    packets, pkts = _packets()
    shown = [p.input_frameno for p in pkts if p.show_frame]
    checks, _ = check.run_check(packets, shown, [], workers=1, control=True)
    assert checks["mismatched_samples"]["value"] > 0
    assert not check.passed(checks)
    result, lines = tiny_run("ld720.live", seconds=1.0, control=True)
    assert result["correct"] is False
    assert result["checks"]["mismatched_samples"]["value"] > 0
    assert "check mismatched_samples 0 limit 0" not in lines


def test_order_errors():
    assert check.order_errors([0, 1, 2, 3], [3]) == 0
    assert check.order_errors([0, 2, 1], []) == 2
    assert check.order_errors([0, 1], [4]) == 1


@pytest.mark.parametrize("workload", ["ra1080.vod", "ld720.live"])
def test_fixed_frames_whatever_the_window(workload):
    """bytes_per_frame and psnr_y_db count the same frames, whatever the
    window's length."""
    a, _ = tiny_run(workload, seconds=0.5)
    b, _ = tiny_run(workload, seconds=3.0)
    assert a["correct"] and b["correct"]
    for m in ("bytes_per_frame", "psnr_y_db"):
        assert a["metrics"][m] == b["metrics"][m]


@pytest.mark.card
def test_control_on_the_card(card):
    """The control at a cell's own size on the card, one seed (the chip
    runs in PERF.md used more): ``run.py --control`` is not correct."""
    import json
    import subprocess
    import sys

    from encbench.tests.conftest import ROOT

    out = subprocess.run(
        [sys.executable, "encbench/run.py", "--workload", "ld720.live",
         "--seed", "4000000007", "--seconds", "3", "--trace", "0",
         "--control"], cwd=ROOT, capture_output=True, text=True,
        timeout=900, check=True)
    result = json.loads(out.stdout.splitlines()[-1])
    assert result["correct"] is False
    assert result["checks"]["mismatched_samples"]["value"] > 0


def test_segments_in_processes():
    """Two key-frame segments decoded in processes of their own read as in
    one process."""
    packets, pkts = _packets()
    packets = packets + [(d, [q.copy() for q in r], k) for d, r, k in packets]
    shown = [p.input_frameno for p in pkts if p.show_frame]
    checks, details = check.run_check(packets, shown, [], workers=2)
    assert details["segments"] == 2 and check.passed(checks)
    packets[-1][1][0][2, 9] ^= 1
    checks, details = check.run_check(packets, shown, [], workers=2)
    assert checks["mismatched_samples"]["value"] == 1
    assert details["first_fault"][0].startswith("segment 1:")
