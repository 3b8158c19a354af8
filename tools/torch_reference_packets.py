#!/usr/bin/env python3
"""rav1e_tpu's packets at every cell of ``reference_cells.py``: the store
that rav1e_tpu_torch is held against.

    JAX_PLATFORMS=cpu python tools/torch_reference_packets.py [--jobs N]
        [--cells NAME ...] [--out PATH]

Encodes each cell with the JAX package on the CPU, its analysis on one
device (``RAV1E_TPU_NO_SHARD=1``), each cell in a worker process of its own
(the JAX compiles take most of the time), and writes
``tests/data/torch_reference_packets.json``: per cell its settings, per
packet its length, frame type and SHA-256, the count of the pipeline's
stage spans, the command that made it and the commit it ran on.  With
``--cells`` only those cells are made anew and the others kept from the
file at ``--out``.  This is the one file of the port's tooling that imports
rav1e_tpu; ``tests/test_torch_reference_packets.py`` runs it in a ``slow``
test and requires the stored file to equal what it makes.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STORE = os.path.join(ROOT, "tests", "data", "torch_reference_packets.json")
sys.path.insert(0, ROOT)

import reference_cells  # noqa: E402

# before any worker imports JAX: the CPU, one device
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["RAV1E_TPU_NO_SHARD"] = "1"


def _commit():
    out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                         capture_output=True, text=True)
    return out.stdout.strip() or None


def _reference_cell(name):
    """(name, packet records, span counts, seconds) of one cell encoded by
    rav1e_tpu; every packet decodes to its reconstruction."""
    import numpy as np

    import rav1e_tpu
    from rav1e_tpu import native
    from rav1e_tpu.decoder import decode_packet

    if native.get_lib() is None:
        raise RuntimeError("rav1e_tpu's native coder did not load: the "
                           "chain would not run")
    t = time.monotonic()
    pkts, _ctx, spans = reference_cells.encode_traced(rav1e_tpu, name)
    seconds = time.monotonic() - t
    state = None
    for i, p in enumerate(pkts):
        dec, state = decode_packet(p.data, state)
        if p.rec is None or dec is None:
            continue
        for pi, dp in enumerate(dec.planes):
            a = dp.as_array()
            b = p.rec.planes[pi].as_array()[: a.shape[0], : a.shape[1]]
            if not np.array_equal(a, b):
                raise RuntimeError(f"{name}: packet {i} plane {pi} does not "
                                   "decode to its reconstruction")
    return (name, [reference_cells.packet_record(p) for p in pkts], spans,
            seconds)


def make(names, jobs):
    """The store's entries for ``names``, by cell name."""
    command = "JAX_PLATFORMS=cpu python " + " ".join(
        [os.path.relpath(os.path.abspath(sys.argv[0]), ROOT)] + sys.argv[1:])
    commit = _commit()
    # the longest first: the bench clip takes minutes
    names = sorted(names, key=lambda n: reference_cells.CELLS[n]["small"])
    with multiprocessing.get_context("spawn").Pool(jobs) as pool:
        done = pool.map(_reference_cell, names, chunksize=1)
    out = {}
    for name, packets, spans, seconds in done:
        out[name] = {"settings": reference_cells.CELLS[name],
                     "packets": packets, "spans": spans,
                     "command": command, "commit": commit,
                     "seconds": round(seconds, 3)}
        print(f"{name:24s} {len(packets)} packets, spans {spans}, "
              f"{seconds:.1f} s", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", nargs="*", help="make only these cells")
    ap.add_argument("--jobs", type=int, default=4,
                    help="worker processes (each holds one JAX runtime)")
    ap.add_argument("--out", default=STORE)
    args = ap.parse_args(argv)
    names = args.cells or list(reference_cells.CELLS)
    unknown = [n for n in names if n not in reference_cells.CELLS]
    if unknown:
        ap.error(f"unknown cells: {unknown}")
    cells = {}
    if args.cells and os.path.exists(args.out):
        with open(args.out) as f:
            cells = json.load(f)["cells"]
    t = time.monotonic()
    cells.update(make(names, max(1, min(args.jobs, len(names)))))
    store = {
        "about": "rav1e_tpu's packets at the cells of reference_cells.py, "
                 "made by tools/torch_reference_packets.py",
        "cells": {n: cells[n] for n in reference_cells.CELLS if n in cells},
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(store, f, indent=1)
        f.write("\n")
    print(f"wrote {args.out}: {len(store['cells'])} cells in "
          f"{time.monotonic() - t:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
