"""rav1e_tpu_torch against rav1e_tpu's stored packets, port only.

``tests/data/torch_reference_packets.json`` holds rav1e_tpu's packets (per
packet its length, frame type and SHA-256) at every cell of
``reference_cells.py``: the ten configurations of chip_smoke.py (10 and 12
bit, 4:2:2, 4:4:4, 2x2 tiles, low latency, speeds 8, 9 and 10, a ragged
clip) at the smallest size where their device stages run, the golden clip
of tests/test_golden_bitstream.py at ``s8-device`` and ``s6-device-10bit``
and at 4:2:2 (where the CDEF search filters), four fuzz seeds and bench.py's
clip.  ``tools/torch_reference_packets.py``
makes it from the JAX package on the CPU, whose compiles cost minutes; the
reference cannot change under the port, and the ``slow`` test here makes
the store anew and requires it to equal the file.

Each small cell runs through the port on the CPU here (plain versions, no
kernel launch) and must give every stored packet, with the device analysis
in every cell and the chain where the card runs it.  chip_smoke.py's
``reference`` phase holds the card to the same store, the bench clip
included.  Also: ``bench_torch.py`` runs bench.py's workload, on bench.py's
frames."""

import importlib.util
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench_torch  # noqa: E402
import rav1e_tpu_torch as r  # noqa: E402
import reference_cells  # noqa: E402
from rav1e_tpu_torch import native  # noqa: E402
from rav1e_tpu_torch.decoder import decode_packet  # noqa: E402
from rav1e_tpu_torch.device import kernels  # noqa: E402
from torch_threads import one_torch_cpu_thread  # noqa: E402,F401

STORE = ROOT / "tests" / "data" / "torch_reference_packets.json"


@pytest.fixture(scope="module")
def store():
    with open(STORE) as f:
        return json.load(f)["cells"]


def test_store_holds_every_cell(store):
    assert list(store) == list(reference_cells.CELLS)
    for name, cell in reference_cells.CELLS.items():
        entry = store[name]
        assert entry["settings"] == cell, name
        assert entry["packets"] and entry["command"] and entry["commit"]
        assert entry["spans"]["device_analysis"] >= 1, name
    assert STORE.stat().st_size < 1 << 20


@pytest.mark.parametrize("name", [
    pytest.param(n, marks=() if c["small"] else pytest.mark.slow)
    for n, c in reference_cells.CELLS.items()])
def test_port_gives_reference_packets(name, store):
    """The bench clip (``slow``: about a minute here) is the north star:
    bench.py's clip at speed 6, the chain on."""
    assert native.get_lib() is not None  # the chain replays natively
    want = store[name]
    kernels.reset_launches()
    pkts, _ctx, spans = reference_cells.encode_traced(r, name, device="cpu")
    got = [reference_cells.packet_record(p) for p in pkts]
    err = reference_cells.first_difference(got, want["packets"])
    assert err is None, f"{name}: {err}"
    # the device stages ran, as in the reference, on the plain versions
    assert spans == want["spans"]
    assert spans["device_analysis"] >= 1
    if reference_cells.CELLS[name]["chain"]:
        assert spans["chain_replay_code"] >= 1
    assert all(n == 0 for n in kernels.LAUNCHES.values())
    state = None
    for i, p in enumerate(pkts):
        dec, state = decode_packet(p.data, state)
        if p.rec is None or dec is None:
            continue
        for pi, dp in enumerate(dec.planes):
            a = dp.as_array()
            b = p.rec.planes[pi].as_array()[: a.shape[0], : a.shape[1]]
            assert np.array_equal(a, b), f"packet {i} plane {pi}"


def _bench_py():
    spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Plane:
    def __init__(self, h, w):
        self.cfg = type("Cfg", (), {"height": h, "width": w})
        self.arr = None

    def copy_from(self, arr):
        self.arr = arr


class _Context:
    """What bench.py's synth_frame asks of a context: 4:2:0 planes."""

    def __init__(self, w, h):
        self.shapes = ((h, w), ((h + 1) // 2, (w + 1) // 2),
                       ((h + 1) // 2, (w + 1) // 2))

    def new_frame(self):
        return type("Frame", (), {"planes": [_Plane(*s)
                                             for s in self.shapes]})


def test_bench_clip_is_bench_py_clip():
    """bench_torch.py's warm-up and timed frames, the first timed run being
    the store's bench cell, are the frames bench.py draws."""
    bench = _bench_py()
    cell = reference_cells.CELLS["bench clip"]
    w, h, n = cell["width"], cell["height"], cell["frames"]
    runs = bench_torch.clip_runs(cell)
    rng = np.random.default_rng(cell["seed"])
    ctx = _Context(w, h)
    want = [[bench.synth_frame(ctx, rng, w, h, t)
             for t in range(len(run))] for run in runs]
    assert [len(run) for run in runs] == [cell["warm_frames"]] + [n] * 3
    for run, wrun in zip(runs, want):
        for planes, f in zip(run, wrun):
            for a, p in zip(planes, f.planes):
                assert np.array_equal(a, p.arr)
    enc = reference_cells.encoder_config(r, cell)
    for a, b in zip(reference_cells.clip(cell, enc), runs[1]):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    # bench.py's settings
    assert (enc.width, enc.height, enc.quantizer, enc.low_latency,
            enc.min_key_frame_interval, enc.max_key_frame_interval) == (
        640, 384, 120, False, 0, 9999)
    assert enc.speed_settings == r.EncoderConfig().speed_settings


def test_bench_torch_runs_on_the_cpu():
    """The smoke size: below 64 pixels a side, where no device stage runs."""
    out = io.StringIO()
    with redirect_stdout(out):
        assert bench_torch.main(["--device", "cpu", "--width", "48",
                                 "--height", "48", "--frames", "2"]) == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["unit"] == "fps" and line["value"] > 0


@pytest.mark.slow
def test_store_equals_a_live_regeneration(tmp_path, store):
    """Every cell made anew from rav1e_tpu (the bench clip included) equals
    the store: packets, span counts and settings."""
    out = tmp_path / "store.json"
    run = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "torch_reference_packets.py"),
         "--out", str(out), "--jobs", "4"],
        cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=3000)
    assert run.returncode == 0, run.stderr[-3000:]
    with open(out) as f:
        fresh = json.load(f)["cells"]
    assert list(fresh) == list(store)
    for name, entry in fresh.items():
        for key in ("settings", "packets", "spans"):
            assert entry[key] == store[name][key], f"{name}: {key}"
