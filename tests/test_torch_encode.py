"""rav1e_tpu_torch end to end: the speed-6 device-analysis slice with the
device chain off, and the default preset with the chain on, give the same
packets as rav1e_tpu, byte for byte, and every packet decodes to its
reconstruction (both at 192x128, so the reference's analysis compiles once
in this module; more chain-on encodes are tests/test_torch_chain_encode.py's
``slow`` tests), and the two command-line encoders at speed 6 on the
chain-on clip.  Also: the port imports neither JAX nor
anything of rav1e_tpu, its constant tables equal the reference's, its Config
runs on CUDA unless asked for the CPU, it accepts the device chain,
GOP-parallel slots and a mesh shape, and it refuses devices it cannot run
on."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import native_libs
import rav1e_tpu
import rav1e_tpu_torch
from rav1e_tpu.decoder import decode_packet
from rav1e_tpu_torch.decoder import decode_packet as port_decode_packet
from torch_threads import one_torch_cpu_thread  # noqa: F401

# before any test runs: see tests/native_libs.py
native_libs.build()

ROOT = Path(__file__).resolve().parent.parent
# 4 frames, as the chain-on test: the two reference encodes then compile the
# same analysis variants once (inter+bwd2 analysis is test_torch_analysis's)
W, H, NFRAMES = 192, 128, 4


def _config(pkg, **kw):
    """The same settings as each package's own objects: a port object never
    equals its rav1e_tpu twin."""
    ss = pkg.SpeedSettings.from_preset(6)
    ss.device_chain = False
    return pkg.Config(
        enc=pkg.EncoderConfig(
            width=W, height=H, quantizer=115, low_latency=False,
            speed_settings=ss, min_key_frame_interval=0,
            max_key_frame_interval=999,
        ),
        **kw,
    )


def _encode(cfg, pkg):
    ctx = cfg.new_context()
    rng = np.random.default_rng(77)
    coarse = rng.integers(0, 256, (H // 8 + 2, W // 8 + 2))
    base = np.repeat(np.repeat(coarse, 8, 0), 8, 1)[:H, :W]
    for t in range(NFRAMES):
        f = ctx.new_frame()
        for i, p in enumerate(f.planes):
            ch, cw = p.cfg.height, p.cfg.width
            arr = (np.roll(base, 2 * t, axis=1) if i == 0
                   else np.full((ch, cw), 128)) + rng.integers(-2, 3, (ch, cw))
            p.copy_from(np.clip(arr, 0, 255).astype(np.uint8))
        ctx.send_frame(f)
    ctx.flush()
    pkts = []
    while True:
        try:
            pkts.append(ctx.receive_packet())
        except pkg.EncoderStatus.LimitReached:
            return pkts


def test_slice_packets_match_reference(monkeypatch):
    from rav1e_tpu.device import analysis as ana
    from rav1e_tpu_torch.device import kernels
    from rav1e_tpu_torch.utils import trace

    # the reference on one device (see test_torch_analysis)
    monkeypatch.setenv("RAV1E_TPU_NO_SHARD", "1")
    ana._analysis_mesh.cache_clear()
    try:
        want = _encode(_config(rav1e_tpu), rav1e_tpu)
    finally:
        ana._analysis_mesh.cache_clear()

    # the port's own trace module: the reference's is another object
    monkeypatch.setattr(trace, "_enabled", True)
    trace.reset()
    kernels.reset_launches()
    got = _encode(_config(rav1e_tpu_torch, device="cpu"), rav1e_tpu_torch)
    spans = trace.stage_summary()
    trace.reset()

    assert len(got) == len(want) >= NFRAMES
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.data == w.data, f"packet {i} differs"
    # every packet decodes to its reconstruction, through the port's own
    # decoder and through the reference's
    for decode in (port_decode_packet, decode_packet):
        state = None
        for i, p in enumerate(got):
            dec, state = decode(p.data, state)
            if p.rec is None:
                continue
            for pi, dp in enumerate(dec.planes):
                a = dp.as_array()
                b = p.rec.planes[pi].as_array()[: a.shape[0], : a.shape[1]]
                assert np.array_equal(a, b), f"packet {i} plane {pi}"
    # the port's device stages ran, on the CPU with the plain versions
    assert spans["device_analysis"]["count"] >= NFRAMES
    assert spans["cdef_rdo_device"]["count"] >= 1
    assert all(n == 0 for n in kernels.LAUNCHES.values())


def test_chain_packets_match_reference(monkeypatch):
    """The default preset (device chain on), 4 frames: three chain frames,
    two of them predispatched."""
    native_libs.require()
    from test_torch_chain_encode import (
        check_chain_encode,
        port_run,
        reference_packets,
    )

    want = reference_packets(W, H, 4)
    got, ctx, spans, dispatches = port_run(W, H, 4, monkeypatch)
    check_chain_encode(want, got, ctx, spans, dispatches, need_bwd=False)


def test_cli_chain_on_matches_reference(tmp_path, capsys, monkeypatch):
    """``rav1e_tpu_torch.cli`` and ``rav1e_tpu.cli`` at speed 6 (chain on)
    with the settings and the clip of test_chain_packets_match_reference,
    whose reference compiles this reuses: equal IVF payloads and
    reconstructions, and the port's inter frames went through the chain."""
    from rav1e_tpu import cli as ref_cli
    from rav1e_tpu.device import analysis as ana
    from rav1e_tpu_torch import cli as port_cli
    from rav1e_tpu_torch.io import read_ivf
    from rav1e_tpu_torch.utils import trace
    from test_torch_chain_encode import clip_planes

    native_libs.require()
    src = tmp_path / "in.y4m"
    with open(src, "wb") as f:
        f.write(f"YUV4MPEG2 W{W} H{H} F30:1 Ip A1:1 C420jpeg\n".encode())
        for planes in clip_planes(W, H, 4):
            f.write(b"FRAME\n" + b"".join(p.tobytes() for p in planes))
    flags = ["-s", "6", "-q", "120", "-i", "0", "-I", "9999"]
    out = {}
    monkeypatch.setenv("RAV1E_TPU_NO_SHARD", "1")
    ana._analysis_mesh.cache_clear()
    monkeypatch.setattr(trace, "_enabled", True)
    trace.reset()
    try:
        for name, main, extra in (("ref", ref_cli.main, []),
                                  ("port", port_cli.main,
                                   ["--device", "cpu"])):
            ivf, rec = tmp_path / f"{name}.ivf", tmp_path / f"{name}.y4m"
            assert main([str(src), "-o", str(ivf), "-r", str(rec), *flags,
                         *extra]) == 0
            with open(ivf, "rb") as f:
                out[name] = ([d for _pts, d in read_ivf(f)],
                             rec.read_bytes())
        spans = trace.stage_summary()
    finally:
        trace.reset()
        ana._analysis_mesh.cache_clear()
    assert len(out["port"][0]) >= 4
    assert out["port"] == out["ref"]
    assert spans["chain_replay_code"]["count"] >= 1


def _imports_of_rav1e_tpu(path):
    """(line, statement) of each import of rav1e_tpu or rav1e_tpu.*, and of
    jax or jax.*, in a file, top level or inside a function."""
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            if name in ("rav1e_tpu", "jax") or name.startswith(
                    ("rav1e_tpu.", "jax.")):
                bad.append((node.lineno, name))
    return bad


def _port_files():
    return (sorted((ROOT / "rav1e_tpu_torch").rglob("*.py"))
            + [ROOT / "chip_smoke.py", ROOT / "tools" / "torch_slice_profile.py",
               ROOT / "tools" / "grid_search_bench.py",
               ROOT / "tools" / "gop_channel_profile.py",
               ROOT / "tools" / "mesh_profile.py", ROOT / "bench_torch.py",
               ROOT / "tools" / "chain_graphs_bench.py",
               ROOT / "reference_cells.py",
               ROOT / "tests" / "test_torch_reference_packets.py",
               ROOT / "tests" / "test_torch_native_tile.py",
               ROOT / "tests" / "test_torch_chain_graphs.py",
               ROOT / "tests" / "test_torch_analysis_graphs.py",
               ROOT / "tests" / "test_torch_program_store.py",
               ROOT / "tests" / "test_torch_mesh_graphs.py",
               ROOT / "tests" / "host_reads.py"])


def test_port_imports_nothing_of_rav1e_tpu():
    files = _port_files()
    assert len(files) > 40
    assert ROOT / "rav1e_tpu_torch" / "parallel" / "mesh.py" in files
    assert ROOT / "rav1e_tpu_torch" / "parallel" / "dryrun.py" in files
    assert ROOT / "rav1e_tpu_torch" / "device" / "graphs.py" in files
    found = {str(f.relative_to(ROOT)): b for f in files
             if (b := _imports_of_rav1e_tpu(f))}
    assert found == {}
    # the port's C shim embeds the interpreter and imports the port's glue
    shim = (ROOT / "rav1e_tpu_torch" / "capi" / "capi.cc").read_text()
    import re

    assert re.findall(r'PyImport_ImportModule\("([\w.]+)"\)', shim) == [
        "rav1e_tpu_torch.capi_glue"]


def test_import_scan_catches_rav1e_tpu(tmp_path):
    """The scan above matches the JAX package, JAX and their modules, lazy
    imports included, and not the port's own name nor a name that only
    starts with "jax"."""
    f = tmp_path / "m.py"
    f.write_text(
        "import rav1e_tpu_torch\n"
        "from rav1e_tpu_torch.ops import cdef\n"
        "import rav1e_tpu\n"
        "def g():\n"
        "    from rav1e_tpu.ops import cdef\n"
        "    import rav1e_tpu.tables as t\n"
        "from . import sibling\n"
        "import jaxtyping\n"
        "def h():\n"
        "    import jax\n"
        "    from jax import numpy\n"
        "    import jax.numpy as jnp\n"
    )
    assert _imports_of_rav1e_tpu(f) == [
        (3, "rav1e_tpu"), (5, "rav1e_tpu.ops"), (6, "rav1e_tpu.tables"),
        (10, "jax"), (11, "jax"), (12, "jax.numpy")]


def test_port_never_imports_jax(tmp_path):
    """An encode and decode, the CLI, the GOP-parallel channel, the C API's
    glue, the fuzzing, metrics and activity modules and a sharded analysis:
    after them neither JAX nor rav1e_tpu is loaded."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import rav1e_tpu_torch as r\n"
        "ss = r.SpeedSettings.from_preset(6)\n"
        "cfg = r.Config(enc=r.EncoderConfig(width=64, height=64, "
        "speed_settings=ss), device='cpu')\n"
        "ctx = cfg.new_context()\n"
        "for t in range(2):\n"
        "    f = ctx.new_frame()\n"
        "    for p in f.planes:\n"
        "        p.copy_from(np.full((p.cfg.height, p.cfg.width), 60 + t,"
        " np.uint8))\n"
        "    ctx.send_frame(f)\n"
        "ctx.flush()\n"
        "pkts = []\n"
        "while True:\n"
        "    try:\n"
        "        pkts.append(ctx.receive_packet())\n"
        "    except r.EncoderStatus.LimitReached:\n"
        "        break\n"
        "n = len(pkts)\n"
        "assert n >= 2, n\n"
        "from rav1e_tpu_torch.decoder import decode_packet\n"
        "state = None\n"
        "for p in pkts:\n"
        "    dec, state = decode_packet(p.data, state)\n"
        "from rav1e_tpu_torch import capi_glue, cli\n"
        "from rav1e_tpu_torch.ops import activity\n"
        "from rav1e_tpu_torch.utils import fuzzing, metrics\n"
        "src = sys.argv[1] + '/in.y4m'\n"
        "with open(src, 'wb') as f:\n"
        "    f.write(b'YUV4MPEG2 W64 H48 F30:1 C420jpeg\\n')\n"
        "    for t in range(2):\n"
        "        f.write(b'FRAME\\n' + bytes([70 + t]) * (64 * 48 * 3 // 2))\n"
        "assert cli.main([src, '-o', sys.argv[1] + '/o.ivf', '--metrics',"
        " '--device', 'cpu']) == 0\n"
        "cfg = r.Config(enc=r.EncoderConfig(width=48, height=48, "
        "min_key_frame_interval=1, max_key_frame_interval=1), device='cpu',"
        " parallel_gops=2)\n"
        "sender, receiver = cfg.new_channel()\n"
        "for t in range(2):\n"
        "    f = sender.new_frame()\n"
        "    for p in f.planes:\n"
        "        p.copy_from(np.full((p.cfg.height, p.cfg.width), 50 + t,"
        " np.uint8))\n"
        "    sender.send(f)\n"
        "sender.close()\n"
        "assert len(list(receiver)) == 2\n"
        "assert fuzzing.fuzz_construct_context(0, 'cpu') in (True, False)\n"
        "from rav1e_tpu_torch.parallel import make_mesh, "
        "sharded_frame_analysis\n"
        "mesh = make_mesh(2, devices=['cpu'] * 2)\n"
        "out = sharded_frame_analysis(mesh, np.full((128, 64), 90), 120, "
        "30.0)\n"
        "assert out[0].shape == (16, 8) and out[3] > 0\n"
        "assert 'jax' not in sys.modules\n"
        "mods = [m for m in sys.modules\n"
        "        if m == 'rav1e_tpu' or m.startswith('rav1e_tpu.')]\n"
        "assert not mods, mods\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_constants_equal_reference():
    from rav1e_tpu.device import analysis as ra
    from rav1e_tpu.device import me as rm
    from rav1e_tpu.device import pallas_kernels as rp
    from rav1e_tpu.ops import cdef, intra
    from rav1e_tpu.partition import intra_mode_to_angle
    from rav1e_tpu_torch.device import analysis as ta
    from rav1e_tpu_torch.device import constants as c

    assert c.SIZE_LOG2S == ra.SIZE_LOG2S and c.N_MODES == ra.N_MODES
    assert (c.HDR_BITS, c.SPLIT_BITS, c.INTER_BITS) == (
        ra.HDR_BITS, ra.SPLIT_BITS, ra.INTER_BITS)
    np.testing.assert_array_equal(c.MODE_BITS, ra.MODE_BITS)
    assert c.EDGE_KERNELS == ra._EDGE_KERNELS
    assert c.ME_BLOCK == rm.ME_BLOCK and c.SUBPEL_OFFS == rm._SUBPEL_OFFS
    assert list(c.subpel_variants()) == list(rm._subpel_variants())
    assert (c.L2_CLIP, c.L1_CLIP, c.L0_CLIP, c.PAD_L2, c.PAD_L1,
            c.PAD_L0) == (rm._L2_CLIP, rm._L1_CLIP, rm._L0_CLIP, rm._PAD_L2,
                          rm._PAD_L1, rm._PAD_L0)
    np.testing.assert_array_equal(c.hadamard8_f32(), ra._hadamard8_f32())
    k = rp._kron_h8x2()[:64, :64]
    np.testing.assert_array_equal(np.kron(c.hadamard8_f32(),
                                          c.hadamard8_f32()), k)
    for sl in c.SIZE_LOG2S:
        s = 1 << sl
        mine, ref = c.dct_basis(s), ra._dct_basis(s)
        np.testing.assert_array_equal(mine[0], ref[0])
        np.testing.assert_array_equal(mine[1], ref[1])
        assert mine[2:] == ref[2:]
        for mode in ta._DIR_MODES:
            ang = intra_mode_to_angle(mode)
            st = c.ief_static(s, ang)
            assert st == ra._ief_static(s, ang)
            for ua in (0, 1):
                for ul in (0, 1):
                    La = 2 * st[4] + 1 if ua else 2 * s + 1
                    Ll = 2 * st[5] + 1 if ul else 2 * s + 1
                    a = c.dir_plan(s, ang, ua, ul, La, Ll)
                    b = ra._dir_plan(s, ang, ua, ul, La, Ll)
                    _assert_nested_equal(a, b)
        for num in (s + 1, 2 * s + 1):
            _assert_nested_equal(c.filter_idx(2 * s + 1, num),
                                 ra._filter_idx(2 * s + 1, num))

    # the tensors built from the reference's numpy sources
    t = c.from_reference("cpu")
    np.testing.assert_array_equal(t.hadamard8.numpy(), ra._hadamard8_f32())
    np.testing.assert_array_equal(t.mode_bits.numpy(), ra.MODE_BITS)
    for s, w in t.sm_weights.items():
        np.testing.assert_array_equal(w.numpy(), intra.SM_WEIGHTS[s])
        fv, fh, gain2, lts = t.dct[s]
        ref = ra._dct_basis(s)
        np.testing.assert_array_equal(fv.numpy(), ref[0])
        np.testing.assert_array_equal(fh.numpy(), ref[1])
        assert (gain2, lts) == ref[2:]
    mats = cdef._partial_matrices()
    np.testing.assert_array_equal(
        t.cdef_partial.numpy(), mats.transpose(1, 0, 2).reshape(64, 120))
    np.testing.assert_array_equal(t.cdef_uv_dir_422.numpy(),
                                  cdef.CDEF_UV_DIR_422)


def _assert_nested_equal(a, b):
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_nested_equal(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


# parallel_gops > 1 runs since GOP-parallel encoding was ported, and
# mesh_shape is carried since the mesh was; their cases stay in this list,
# now ones that are accepted
ACCEPTED = {"parallel_gops", "mesh_shape"}


@pytest.mark.parametrize(
    "field,value,match",
    [
        ("mesh_shape", {"tile": 2}, "mesh_shape"),
        ("parallel_gops", 2, "parallel_gops"),
        ("device", "default", "CUDA is not available"),
        ("device", "tpu", "tpu"),
        ("device", "cuda:7", "cuda:7"),
    ],
)
def test_config_rejects_unported_settings(field, value, match, monkeypatch):
    import torch

    # "cuda:7" must be refused whether or not a card is present
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    if value == "default":
        # no device given -> "cuda", with no fallback to the CPU on a box
        # without a card
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cfg = _config(rav1e_tpu_torch)
        assert cfg.device == "cuda"
    else:
        cfg = _config(rav1e_tpu_torch, device="cpu")
    if value != "default":
        setattr(cfg, field, value)
    if field in ACCEPTED:
        cfg.new_context()
        assert getattr(cfg, field) == value
        sender, receiver = cfg.new_channel()
        sender.close()
        assert list(receiver) == []
        return
    with pytest.raises(rav1e_tpu_torch.InvalidConfig, match=match):
        cfg.new_context()


def test_config_accepts_device_chain():
    """device_chain=True (the default speed-6 preset) is accepted on the CPU,
    and an encode codes inter frames through the chain: its device recon
    fills the chain's reference slots."""
    import rav1e_tpu_torch as r

    ss = r.SpeedSettings.from_preset(6)
    assert ss.device_chain
    cfg = r.Config(enc=r.EncoderConfig(width=128, height=64, quantizer=120,
                                       speed_settings=ss), device="cpu")
    ctx = cfg.new_context()
    assert ctx.pipeline._chain_applicable()
    rng = np.random.default_rng(3)
    for t in range(3):
        f = ctx.new_frame()
        for p in f.planes:
            p.copy_from(rng.integers(60, 70, (p.cfg.height, p.cfg.width),
                                     dtype=np.uint8))
        ctx.send_frame(f)
    ctx.flush()
    while True:
        try:
            ctx.receive_packet()
        except r.EncoderStatus.LimitReached:
            break
    assert any(s is not None for s in ctx.pipeline._chain_slots)


def test_config_accepts_cpu():
    ctx = _config(rav1e_tpu_torch, device="cpu").new_context()
    assert str(ctx.pipeline.device) == "cpu"
