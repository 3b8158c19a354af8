"""rav1e_tpu_torch.parallel and the analysis mesh against rav1e_tpu's.

The port's mesh here is CPU slots (``make_mesh(n, devices=["cpu"] * n)``),
the reference's the 8 virtual CPU devices of tests/conftest.py.

- sharded_frame_analysis / sharded_inter_analysis: the reference's
  functions on the same seeded inputs and shapes as tests/test_parallel.py
  (maps and MVs exactly equal, bits within 1e-5 relative);
- the analysis mesh (device/analysis.py): DeviceMaps sharded == unsharded,
  bits_est included, for key and inter frames, at a height whose
  superblock rows split unevenly and at one with fewer rows than slots;
- Context encodes with the mesh: byte for byte the unsharded port's and
  rav1e_tpu's auto-mesh encode (chain off), and the unsharded port's with
  the chain on;
- dryrun_multichip on 4 CPU slots, and make_mesh's refusals.
"""

import numpy as np
import pytest
import torch

import native_libs
import rav1e_tpu
import rav1e_tpu_torch
from rav1e_tpu_torch.device import analysis
from rav1e_tpu_torch.parallel import make_mesh
from rav1e_tpu_torch.parallel.mesh import ShardedPlane, band_rows
from torch_threads import one_torch_cpu_thread  # noqa: F401

# before any test runs: see tests/native_libs.py
native_libs.build()


def cpu_mesh(n):
    return make_mesh(n, devices=["cpu"] * n)


@pytest.fixture
def use_mesh(monkeypatch):
    """Swap the port's analysis mesh for the given one (None: unsharded)."""

    def use(mesh):
        monkeypatch.setattr(analysis, "_analysis_mesh", lambda device: mesh)

    return use


def test_sharded_frame_analysis_matches_reference():
    from rav1e_tpu.parallel import make_mesh as ref_mesh
    from rav1e_tpu.parallel import sharded_frame_analysis as ref_fn
    from rav1e_tpu_torch.parallel import sharded_frame_analysis

    h, w = 8 * 64, 128
    rng = np.random.default_rng(2)
    luma = rng.integers(0, 256, (h, w)).astype(np.int32)
    want = ref_fn(ref_mesh(8), luma, 110, 30.0, 8)
    got = sharded_frame_analysis(cpu_mesh(8), luma, 110, 30.0, 8)
    for name, a, b in zip(("size", "mode", "inter"), got[:3], want[:3]):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert abs(got[3] - want[3]) <= 1e-5 * want[3]


def test_sharded_inter_analysis_matches_reference():
    from rav1e_tpu.parallel import make_mesh as ref_mesh
    from rav1e_tpu.parallel import sharded_inter_analysis as ref_fn
    from rav1e_tpu_torch.parallel import sharded_inter_analysis

    h, w = 4 * 64, 192
    rng = np.random.default_rng(5)
    luma = rng.integers(0, 256, (h, w), dtype=np.int32)
    ref = np.roll(luma, (2, -5), (0, 1)).astype(np.int32)
    want = ref_fn(ref_mesh(4), luma, ref, 110, 30.0, 8)
    got = sharded_inter_analysis(cpu_mesh(4), luma, ref, 110, 30.0, 8)
    for name, a, b in zip(("size", "mode", "inter", "mv0"), got[:4],
                          want[:4]):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got[2].any() and np.abs(got[3]).max() > 0
    assert abs(got[4] - want[4]) <= 1e-5 * want[4]


def _moving_frames(h, w, n=4):
    """A coarse texture moving down and right, so that motion search reads
    across band edges, with noise."""
    rng = np.random.default_rng(9)
    coarse = rng.integers(0, 256, (h // 8 + 6, w // 8 + 4))
    base = np.repeat(np.repeat(coarse, 8, 0), 8, 1).astype(np.int64)
    return [np.clip(base[7 * t : 7 * t + h, 3 * t : 3 * t + w]
                    + rng.integers(-2, 3, (h, w)), 0, 255).astype(np.uint8)
            for t in range(n)]


@pytest.mark.parametrize("kind", ["key", "inter", "inter+bwd", "inter+bwd2"])
@pytest.mark.parametrize("h", [448, 192])
def test_analysis_mesh_equals_unsharded(kind, h, use_mesh):
    """448 rows over 4 slots: bands of 2/2/2/1 superblock rows, each with up
    to ANALYSIS_HALO rows of its neighbours; 192 rows (3 superblock rows) do
    not split and run whole on the first slot."""
    w = 128
    f = _moving_frames(h, w)
    cur, refs = {
        "key": (f[1], (None, None, None)),
        "inter": (f[1], (f[0], None, None)),
        "inter+bwd": (f[1], (f[0], f[2], None)),
        "inter+bwd2": (f[1], (f[0], f[2], f[3])),
    }[kind]
    mesh = cpu_mesh(4)
    rows = band_rows(h, 4)
    assert rows == (((0, 128), (128, 256), (256, 384), (384, 448))
                    if h == 448 else None)

    def run(m):
        use_mesh(m)
        # the planes as the pipeline hands them over: the subject put on the
        # device(s) once, the references as numpy planes
        plane = analysis.upload_source_luma(cur, "cpu")
        assert isinstance(plane, ShardedPlane) == (m is not None and
                                                   rows is not None)
        return analysis.analyze_frame(plane, *refs[:2], 120, 60.0, 8,
                                      ref2_np=refs[2], device="cpu")

    want, got = run(None), run(mesh)
    for name in ("size_log2", "mode", "use_inter", "mv0", "mv1", "mv2"):
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None, name
            continue
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.bits_est == want.bits_est
    if kind != "key":
        assert got.use_inter.any() and np.abs(got.mv0).max() > 0


def test_band_rows():
    assert band_rows(1088, 4) == ((0, 320), (320, 576), (576, 832),
                                  (832, 1088))
    assert band_rows(1024, 4) == tuple((i * 256, (i + 1) * 256)
                                       for i in range(4))
    assert band_rows(128, 2) == ((0, 64), (64, 128))
    assert band_rows(128, 4) is None
    assert band_rows(1088, 1) is None


def _encode_speed8(pkg, mesh=None, use_mesh=None):
    """tests/test_parallel.py's auto-mesh clip: 128x128, 3 frames at speed
    8, chain off."""
    ss = pkg.SpeedSettings.from_preset(8)
    ss.device_chain = False
    kw = {} if pkg is rav1e_tpu else {"device": "cpu"}
    cfg = pkg.Config(enc=pkg.EncoderConfig(
        width=128, height=128, quantizer=120, low_latency=True,
        speed_settings=ss), **kw)
    if use_mesh is not None:
        use_mesh(mesh)
    ctx = cfg.new_context()
    rng = np.random.default_rng(11)
    base = rng.integers(0, 256, (128, 128)).astype(np.uint8)
    for t in range(3):
        f = ctx.new_frame()
        for i, p in enumerate(f.planes):
            p.copy_from(np.roll(base, 2 * t, axis=1) if i == 0 else
                        np.full((p.cfg.height, p.cfg.width), 128, np.uint8))
        ctx.send_frame(f)
    ctx.flush()
    pkts = []
    while True:
        try:
            pkts.append(ctx.receive_packet().data)
        except pkg.EncoderStatus.LimitReached:
            return pkts, ctx


def test_mesh_context_encode_matches_reference_auto_mesh(monkeypatch,
                                                         use_mesh):
    """Two superblock rows over 2 slots: one band per slot."""
    from rav1e_tpu.device import analysis as ref_ana

    monkeypatch.delenv("RAV1E_TPU_NO_SHARD", raising=False)
    ref_ana._analysis_mesh.cache_clear()
    try:
        assert ref_ana._analysis_mesh() is not None  # 8 CPU devices
        want, _ = _encode_speed8(rav1e_tpu)
    finally:
        ref_ana._analysis_mesh.cache_clear()
    single, _ = _encode_speed8(rav1e_tpu_torch, None, use_mesh)
    sharded, ctx = _encode_speed8(rav1e_tpu_torch, cpu_mesh(2), use_mesh)
    assert len(sharded) == 3
    assert sharded == single
    assert sharded == want
    assert any(isinstance(p, ShardedPlane)
               for p in ctx.pipeline._dev_luma_cache.values())


def test_mesh_chain_encode_matches_unsharded(use_mesh):
    """The default preset (device chain on) at 192x128, 4 frames: under the
    mesh the chain does not take the analysis's sharded luma, and the
    packets are the unsharded ones."""
    from test_torch_chain_encode import encode

    native_libs.require()
    use_mesh(None)
    want, _ = encode(rav1e_tpu_torch, 192, 128, 4, device="cpu")
    use_mesh(cpu_mesh(2))
    got, ctx = encode(rav1e_tpu_torch, 192, 128, 4, device="cpu")
    assert [p.data for p in got] == [p.data for p in want]
    assert any(s is not None for s in ctx.pipeline._chain_slots)
    assert any(isinstance(p, ShardedPlane)
               for p in ctx.pipeline._dev_luma_cache.values())


def test_dryrun_multichip_on_cpu_slots():
    from rav1e_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(4, devices=["cpu"] * 4)
    assert len(out["packets"]) == 3
    assert all(b > 0 for b in out["bits"])


def test_make_mesh_refuses_missing_devices(monkeypatch):
    with pytest.raises(RuntimeError, match="need 5 devices, have 4"):
        make_mesh(5, devices=["cpu"] * 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(2)
    with pytest.raises(RuntimeError, match="not visible"):
        make_mesh(2, devices=["cuda:0", "cuda:1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="need 2 devices, have 1"):
        make_mesh(2)
    with pytest.raises(RuntimeError, match="cuda:1 is not visible"):
        make_mesh(devices=["cuda:0", "cuda:1"])
    mesh = make_mesh(3, devices=["cpu"] * 4)
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert mesh.axis == "tile"


def test_analysis_mesh_takes_every_card(monkeypatch):
    """The production mesh: every visible card when the context is on a
    card and there are two or more, else none; RAV1E_TPU_NO_SHARD opts
    out.  (make_mesh touches no card: the slots' streams are made at their
    first use.)"""
    ana = analysis
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delenv("RAV1E_TPU_NO_SHARD", raising=False)
    for count, device, want in ((2, "cuda", 2), (4, "cuda:1", 4),
                                (1, "cuda", None), (4, "cpu", None)):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
        ana._analysis_mesh.cache_clear()
        mesh = ana._analysis_mesh(device)
        if want is None:
            assert mesh is None
        else:
            assert mesh.devices == tuple(torch.device("cuda", i)
                                         for i in range(want))
    monkeypatch.setenv("RAV1E_TPU_NO_SHARD", "1")
    ana._analysis_mesh.cache_clear()
    assert ana._analysis_mesh("cuda") is None
    ana._analysis_mesh.cache_clear()


def test_kernel_wrappers_refuse_tensors_on_two_devices():
    """A band's tensors and another slot's never meet in one launch."""
    from rav1e_tpu_torch.device import kernels

    blocks = torch.zeros((2, 16, 16), dtype=torch.int32)
    ref = torch.zeros((64, 64), dtype=torch.int32, device="meta")
    base = torch.zeros(2, dtype=torch.int32)
    seeds = [torch.zeros((2, 2), dtype=torch.int32)]
    with pytest.raises(ValueError, match="tensors on meta"):
        kernels.check_grid_search_inputs(blocks, ref, base, base, seeds, 16,
                                         2, 1, 38)
