"""The frozen reference decoder against the port's reconstruction, and what
the reference and a run may load."""

import ast
import subprocess
import sys

import numpy as np
import pytest

from encbench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "rav1e_tpu"}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module


def test_no_file_imports_jax_or_the_jax_package():
    for path in (ROOT / "encbench").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
        if "reference" in path.relative_to(ROOT / "encbench").parts:
            assert "rav1e_tpu_torch" not in tops, path


def _modules_after(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split("
         "'.')[0] for m in sys.modules}))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_no_program_and_no_jax():
    tops = _modules_after(
        "from encbench.reference.av1.decoder import decode_packet\n"
        "from encbench import check")
    assert not tops & (FORBIDDEN | {"rav1e_tpu_torch"}), tops


def test_a_run_loads_no_jax():
    """A whole run on the CPU at a tiny size: whole top-level names, so the
    port (rav1e_tpu_torch) is allowed and rav1e_tpu is not."""
    tops = _modules_after(
        "from encbench.tests.conftest import tiny_run\n"
        "if __name__ == '__main__':\n"
        "    res, _ = tiny_run('ld720.live', seconds=1.0)\n"
        "    assert res['correct'], res")
    assert "rav1e_tpu_torch" in tops
    assert not tops & FORBIDDEN, tops


@pytest.mark.parametrize("low_latency", [False, True])
def test_frozen_decoder_reproduces_the_port(low_latency):
    import rav1e_tpu_torch as r

    from encbench.content import Clip
    from encbench.reference.av1.decoder import decode_packet
    from encbench.tests.test_encbench_content import content

    enc = r.EncoderConfig(width=128, height=96, quantizer=100,
                          low_latency=low_latency,
                          speed_settings=r.SpeedSettings.from_preset(6))
    ctx = r.Config(enc=enc, device="cpu").new_context()
    clip = Clip(dict(content("vod"), scene_frames=8), 128, 96, 5)
    for i in range(6):
        f = ctx.new_frame()
        for p, a in zip(f.planes, clip.frame(i)):
            p.copy_from(a)
        ctx.send_frame(f)
    ctx.flush()
    pkts = []
    while True:
        try:
            pkts.append(ctx.receive_packet())
        except r.EncoderStatus.LimitReached:
            break
    assert len(pkts) >= 6
    state = None
    for p in pkts:
        dec, state = decode_packet(p.data, state)
        for dp, rp in zip(dec.planes, p.rec.planes):
            a = dp.as_array()
            assert np.array_equal(a, rp.as_array()[: a.shape[0],
                                                   : a.shape[1]])
