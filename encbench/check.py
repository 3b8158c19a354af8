"""The comparison that decides ``correct``.

Every packet the run received is decoded by the frozen reference decoder
(``reference/av1``) in decode order, and each decoded picture is compared
sample by sample with the reconstruction the program returned with that
packet. A stream splits at its key frames (each carries the sequence
header), so each segment decodes on its own, in a process of its own.

The numbers compared, each with its limit (an exact comparison, limit 0):

- ``undecodable``: packets the decoder refused, and every later packet of
  the same segment, which can no longer be decoded;
- ``mismatched_samples``: samples of decoded pictures that differ from the
  program's reconstruction;
- ``order_errors``: shown frames out of input order, missing or repeated,
  and hidden frames that a later shown packet of the run does not show.

The control (``control=True``) puts in the place of the program's
reconstruction that reconstruction held at the precision below the
configuration's bit depth: its lowest bit cleared, as a 7-bit encoder of the
8-bit configuration would give it. It must fail the comparison.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

LIMITS = {"undecodable": 0, "mismatched_samples": 0, "order_errors": 0}


def _planes(frame):
    """The visible planes of a reconstruction (a Frame or a list of arrays)."""
    if isinstance(frame, (list, tuple)):
        return list(frame)
    return [p.as_array() for p in frame.planes]


def decode_segment(packets, control=False):
    """Decode one segment: ``packets`` is a list of (data, reconstruction
    planes); with ``control`` the reconstructions are held one bit below
    their precision. Returns (undecodable packets, mismatched samples,
    packets with a mismatch, where the first fault lies or None)."""
    from encbench.reference.av1.decoder import decode_packet

    state = None
    mismatched = bad = 0
    first = None
    for i, (data, rec) in enumerate(packets):
        try:
            dec, state = decode_packet(data, state)
        except Exception as e:  # the decoder refused the packet
            return (len(packets) - i, mismatched, bad,
                    first or f"packet {i} of the segment: "
                    f"{type(e).__name__}: {e}")
        before = mismatched
        for pi, dp in enumerate(dec.planes):
            a = dp.as_array()
            want = rec[pi]
            if want.shape[0] < a.shape[0] or want.shape[1] < a.shape[1]:
                mismatched += a.size
                continue
            want = want[: a.shape[0], : a.shape[1]]
            if control:
                want = want >> 1 << 1
            diff = a != want
            n = int(np.count_nonzero(diff))
            if n and first is None:
                ys, xs = np.nonzero(diff)
                first = (f"packet {i} of the segment, plane {pi}: first "
                         f"difference at row {int(ys[0])} column "
                         f"{int(xs[0])}")
            mismatched += n
        bad += mismatched > before
    return 0, mismatched, bad, first


def _worker():
    """A decoding process: one pickled (segment, control) on standard
    input, its :func:`decode_segment` result pickled on standard output."""
    seg, control = pickle.load(sys.stdin.buffer)
    pickle.dump(decode_segment(seg, control), sys.stdout.buffer)


def _decode_in_process(seg, control):
    root = str(Path(__file__).resolve().parent.parent)
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run(
        [sys.executable, "-c", "from encbench.check import _worker; _worker()"],
        input=pickle.dumps((seg, control), protocol=5), capture_output=True,
        cwd=root, env=env, check=True)
    return pickle.loads(out.stdout)


def _in_processes(segs, control, workers):
    """Each segment decoded in a process of its own, ``workers`` at a time,
    their data passed through pipes (nothing written to disk or shared
    memory)."""
    with ThreadPoolExecutor(workers) as pool:
        return list(pool.map(lambda s: _decode_in_process(s, control), segs))


def segments(packets):
    """Split (data, rec, is_key) triples at key frames: lists of (data, rec)."""
    out = []
    for data, rec, is_key in packets:
        if is_key or not out:
            out.append([])
        out[-1].append((data, rec))
    return out


def order_errors(shown_inputs, hidden_inputs) -> int:
    """Shown frames must be input frames 0, 1, 2, ... in order; every hidden
    frame must be shown later by the run."""
    errs = sum(1 for i, f in enumerate(shown_inputs) if f != i)
    errs += len(set(hidden_inputs) - set(shown_inputs))
    return errs


def run_check(packets, shown_inputs, hidden_inputs, workers=None,
              control=False):
    """``packets``: (data, reconstruction planes, is_key) in decode order.
    Returns (checks, details): checks maps each compared number to its
    value and limit; details has the segments, the first faults and the
    packets with a mismatch. With ``control`` the reconstructions compared
    are the control's."""
    segs = segments([(d, _planes(r), k) for d, r, k in packets])
    workers = max(1, min(len(segs), workers or (os.cpu_count() or 1)))
    if workers == 1 or len(segs) == 1:
        results = [decode_segment(s, control) for s in segs]
    else:
        results = _in_processes(segs, control, workers)
    undecodable = sum(r[0] for r in results)
    mismatched = sum(r[1] for r in results)
    firsts = [f"segment {i}: {r[3]}" for i, r in enumerate(results) if r[3]]
    checks = {
        "undecodable": undecodable,
        "mismatched_samples": mismatched,
        "order_errors": order_errors(shown_inputs, hidden_inputs),
    }
    details = {"segments": len(segs), "first_fault": firsts[:3],
               "failed_packets": sum(r[2] for r in results)}
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in checks.items()}, \
        details


def passed(checks) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
