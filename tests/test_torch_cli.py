"""rav1e_tpu_torch's command-line encoder against rav1e_tpu's, in process.

Below 64 pixels on a side neither package runs a device stage, so at 64x48
the two CLIs run the host coders alone (no JAX compile): the IVF bytes, the
``-r`` reconstructions, the ``--psnr`` and ``--metrics`` lines, the pass
files of a 2-pass encode and the ``--set`` refusals must all be equal.  The
port's CLI runs with ``--device cpu``; without it, on a box without a card,
it refuses with InvalidConfig.  The speed-6 chain-on CLI at 192x128 is in
tests/test_torch_encode.py, where it shares the reference's compiles."""

import numpy as np
import pytest

from rav1e_tpu import cli as ref_cli
from rav1e_tpu_torch import InvalidConfig
from rav1e_tpu_torch import cli as port_cli
from torch_threads import one_torch_cpu_thread  # noqa: F401

W, H, N = 64, 48, 6


def write_clip(path, w, h, n, bd=8, seed=0):
    """A seeded panning texture as y4m, written with numpy alone."""
    rng = np.random.default_rng(seed)
    tag = "420jpeg" if bd == 8 else f"420p{bd}"
    dt = "<u1" if bd == 8 else "<u2"
    base = np.repeat(np.repeat(rng.integers(0, 256, (h // 8 + 2, w // 8 + 4)),
                               8, 0), 8, 1)
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F30:1 Ip A1:1 C{tag}\n".encode())
        for t in range(n):
            f.write(b"FRAME\n")
            y = np.clip(base[:h, 2 * t: 2 * t + w]
                        + rng.integers(-2, 3, (h, w)), 0, 255)
            c = np.full(((h + 1) // 2, (w + 1) // 2), 128)
            for plane in (y, c + t, c - t):
                f.write((plane.astype(np.int64) << (bd - 8)).astype(dt)
                        .tobytes())
    return path


def run_both(tmp_path, capsys, clip, *flags):
    """Each CLI on ``clip`` with ``flags``: {"ref"/"port": (ivf bytes,
    stderr lines, the directory of its other outputs)}."""
    out = {}
    for name, main, extra in (("ref", ref_cli.main, []),
                              ("port", port_cli.main, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir(parents=True)
        argv = [str(clip), "-o", str(d / "out.ivf")]
        argv += [str(d / a[2:]) if a.startswith("@@") else a for a in flags]
        capsys.readouterr()
        assert main(argv + extra) == 0
        out[name] = ((d / "out.ivf").read_bytes(),
                     capsys.readouterr().err.splitlines(), d)
    return out


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("report", ["--psnr", "--metrics"])
def test_cli_matches_reference(tmp_path, capsys, bd, report):
    clip = write_clip(tmp_path / "in.y4m", W, H, N, bd)
    got = run_both(tmp_path, capsys, clip, "-s", "6", "-q", "110",
                   "-r", "@@rec.y4m", report)
    ref, port = got["ref"], got["port"]
    assert port[0] == ref[0] and len(ref[0]) > 32 * N
    assert (port[2] / "rec.y4m").read_bytes() == (
        ref[2] / "rec.y4m").read_bytes()
    assert port[1] == ref[1]
    assert len([ln for ln in port[1] if ln.startswith("frame ")]) == N


@pytest.mark.parametrize("bd", [8, 10])
def test_cli_two_pass_matches_reference(tmp_path, capsys, bd):
    """First pass writes rate stats, the second reads them (as
    tests/test_cli_multipass.py runs rav1e_tpu's CLI)."""
    clip = write_clip(tmp_path / "in.y4m", W, H, N, bd, seed=1)
    rate = ["-b", "300", "-q", "0", "-s", "8"]
    first = run_both(tmp_path / "p1", capsys, clip, *rate,
                     "--first-pass", "@@p1.stats")
    for name in ("ref", "port"):
        assert (first[name][2] / "p1.stats").stat().st_size > 0
    assert (first["port"][2] / "p1.stats").read_bytes() == (
        first["ref"][2] / "p1.stats").read_bytes()
    assert first["port"][0] == first["ref"][0]
    stats = first["ref"][2] / "p1.stats"
    second = run_both(tmp_path / "p2", capsys, clip, *rate,
                      "--second-pass", str(stats))
    assert second["port"][0] == second["ref"][0]


@pytest.mark.parametrize("kv", ["nonsense.key=1", "motion.nonsense=1",
                                "cdef", "partition.partition_range=3"])
def test_cli_set_refusals_match_reference(tmp_path, kv):
    clip = write_clip(tmp_path / "in.y4m", W, H, 1)
    errs = []
    for main, extra in ((ref_cli.main, []),
                        (port_cli.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            main([str(clip), "-o", str(tmp_path / "o.ivf"), "--set", kv]
                 + extra)
        errs.append(str(e.value.code))
    assert errs[0] == errs[1] and errs[0] != "0"


def test_cli_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    """No --device: Config's default, the card; without one the CLI refuses
    instead of running on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    clip = write_clip(tmp_path / "in.y4m", W, H, 1)
    with pytest.raises(InvalidConfig, match="CUDA is not available"):
        port_cli.main([str(clip), "-o", str(tmp_path / "o.ivf")])
    assert port_cli.build_parser().parse_args(
        [str(clip), "-o", "x"]).device is None
