"""The first pass (device/firstpass.py) on the CPU, the port alone: the
plain versions of csrc/firstpass.cu's kernels equal the host functions that
a CPU context runs, and a context driven through a first pass on the CPU
places the host's keyframes and codes the host's packets.

- scene detection: the 2x2 downsample, the gradient sums and the 49 shift
  sums give ``_detect_keyframe``'s keyframes over clips with cuts, a
  one-frame flash and a pan, at 8 and 10 bits, at odd sizes and on planes
  8 or fewer samples a side (radius 0);
- the lookahead: intra costs, diamond MVs and inter costs equal
  ``encoder/lookahead.py``'s native and NumPy paths, with MVs that reach
  the frame's edge, a flat plane where every candidate ties, odd 8x8 grids
  past the 16x16 grid, frames under 16 samples a side, and 10-bit samples.

The kernels run only on a card; the tests marked ``card`` hold each one to
its plain version there, and a card encode to a CPU encode (``python -m
pytest tests/test_torch_firstpass.py --noconftest -m card``, without the
JAX that tests/conftest.py imports)."""

import types

import numpy as np
import pytest
import torch

import native_libs
import rav1e_tpu_torch as r
from rav1e_tpu_torch.api.context import ContextInner
from rav1e_tpu_torch.config import SceneDetectionSpeed
from rav1e_tpu_torch.device import firstpass as fp
from rav1e_tpu_torch.device import kernels
from rav1e_tpu_torch.encoder import lookahead as la
from torch_threads import one_torch_cpu_thread  # noqa: F401


def _frame_of(y):
    return types.SimpleNamespace(
        planes=[types.SimpleNamespace(as_array=lambda: y)])


def _t(y):
    """A host luma plane as the first pass holds it."""
    return torch.from_numpy(np.ascontiguousarray(y).astype(
        np.uint8 if y.dtype == np.uint8 else np.int16))


def _plane(rng, h, w, bd):
    return rng.integers(0, 1 << bd, (h, w)).astype(
        np.uint8 if bd == 8 else np.uint16)


def _textured(rng, h, w, bd, t=0, cell=8):
    """A blocky texture panning 3 samples a frame, with grain."""
    coarse = rng.integers(0, 1 << bd, (h // cell + 4, w // cell + 4))
    base = np.repeat(np.repeat(coarse, cell, 0), cell, 1)
    arr = np.roll(base, 3 * t, axis=1)[:h, :w]
    return arr


# ---------------------------------------------------------------------------
# scene detection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w,bd", [(64, 96, 8), (37, 53, 8), (38, 54, 10),
                                    (15, 17, 10), (1, 9, 8), (9, 1, 10)])
def test_downsample_equals_host(h, w, bd):
    y = _plane(np.random.default_rng(h * w + bd), h, w, bd)
    want = ContextInner._downsample_luma(_frame_of(y))
    got = fp.downsample(_t(y))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy().astype(np.uint16), want)


@pytest.mark.parametrize("h,w", [(34, 50), (27, 41), (8, 30), (30, 7)])
def test_scene_sums_are_the_hosts_means(h, w):
    """Each shift's sum over its count is the host's float64 mean, and the
    gradient sums give Standard mode's gx and gy, exactly."""
    rng = np.random.default_rng(h + 100 * w)
    cur = rng.integers(0, 1024, (h, w)).astype(np.uint16)
    prev = rng.integers(0, 1024, (h, w)).astype(np.uint16)
    prev2 = rng.integers(0, 1024, (h, w)).astype(np.uint16)
    r = fp.shift_radius(h, w)
    sums = fp.scene_sums(_t(cur), _t(prev), _t(prev2), r, True)
    gx, gy, mad, mad2 = fp.scene_values(sums.numpy(), h, w, r)
    c = cur.astype(np.int32)
    assert gx == np.abs(np.diff(c.astype(np.float64), axis=1)).mean()
    assert gy == np.abs(np.diff(c.astype(np.float64), axis=0)).mean()
    for k, p in enumerate((prev, prev2)):
        p = p.astype(np.int32)
        means = []
        for i, (dy, dx) in enumerate(fp.shifts(r)):
            a = c[max(dy, 0): h + min(dy, 0), max(dx, 0): w + min(dx, 0)]
            b = p[max(-dy, 0): h + min(-dy, 0), max(-dx, 0): w + min(-dx, 0)]
            n = a.size
            ns = (2 * r + 1) ** 2
            assert int(sums[2 + k * ns + i]) / n == float(np.abs(a - b).mean())
            means.append(float(np.abs(a - b).mean()))
        assert (mad, mad2)[k] == min(means)
    # without gradients or an earlier plane those sums stay zero
    s0 = fp.scene_sums(_t(cur), _t(prev), None, r, False)
    ns = (2 * r + 1) ** 2
    assert int(s0[0]) == int(s0[1]) == 0 and not bool(s0[2 + ns:].any())
    assert torch.equal(s0[2: 2 + ns], sums[2: 2 + ns])


def _clip(kind, h, w, bd, rng):
    """Luma planes: ``cuts`` (three scenes, one pan each), ``flash`` (A A F
    A A A as tests/test_pyramid.py builds it, F = max - A), ``pan``."""
    top = (1 << bd) - 1
    if kind == "flash":
        a = _textured(rng, h, w, bd)
        seq = [a, a, top - a, a, a, a]
    elif kind == "pan":
        seed = int(rng.integers(1 << 30))
        seq = [_textured(np.random.default_rng(seed), h, w, bd, t)
               for t in range(6)]
    else:
        scenes = [int(rng.integers(1 << 30)) for _ in range(3)]
        seq = [_textured(np.random.default_rng(scenes[t // 3]), h, w, bd, t)
               for t in range(9)]
    dt = np.uint8 if bd == 8 else np.uint16
    return [np.clip(p + rng.integers(-2, 3, p.shape), 0, top).astype(dt)
            for p in seq]


def _keyframes(planes, bd, mode, low_latency, first_pass, forced=()):
    """The keyframes a context's scheduler places for these luma planes,
    through the host functions or through a first pass on the CPU."""
    h, w = planes[0].shape
    ss = r.SpeedSettings.from_preset(6)
    ss.scene_detection_mode = mode
    cfg = r.Config(enc=r.EncoderConfig(
        width=w, height=h, bit_depth=bd, quantizer=100,
        low_latency=low_latency, speed_settings=ss,
        min_key_frame_interval=0, max_key_frame_interval=99), device="cpu")
    inner = ContextInner(cfg)
    assert inner._firstpass is None  # a CPU context runs the host path
    if first_pass:
        inner._firstpass = fp.FirstPass("cpu", w, h, bd, keep_luma=False)
    for i, y in enumerate(planes):
        f = r.Frame.new(w, h, cfg.enc.chroma_sampling, bd)
        f.planes[0].copy_from(y)
        params = (r.FrameParameters(frame_type_override="key")
                  if i in forced else None)
        inner.send_frame(f, params)
    return sorted(inner.keyframes)


@pytest.mark.parametrize("kind", ["cuts", "flash", "pan"])
@pytest.mark.parametrize("h,w,bd", [(64, 96, 8), (58, 86, 10), (16, 40, 8)])
def test_scene_decisions_equal_host(kind, h, w, bd):
    rng = np.random.default_rng(len(kind) * 1000 + h + bd)
    planes = _clip(kind, h, w, bd, rng)
    for mode in (SceneDetectionSpeed.Standard, SceneDetectionSpeed.Fast):
        for low_latency in (True, False):
            want = _keyframes(planes, bd, mode, low_latency, False)
            got = _keyframes(planes, bd, mode, low_latency, True)
            assert got == want, (mode, low_latency)
            if kind == "flash" and (h, w) != (16, 40):
                assert want == [0], want  # the flash left no keyframe
            if kind == "cuts":
                assert len(want) > 1, want


def test_scene_decisions_after_a_forced_key():
    """A forced key frame's plane becomes the previous plane; the one before
    stays (the host's order)."""
    rng = np.random.default_rng(7)
    planes = _clip("flash", 48, 64, 8, rng) + _clip("cuts", 48, 64, 8, rng)
    for forced in ((2,), (3, 7), (1, 2)):
        want = _keyframes(planes, 8, SceneDetectionSpeed.Standard, True,
                          False, forced)
        got = _keyframes(planes, 8, SceneDetectionSpeed.Standard, True, True,
                         forced)
        assert got == want, forced


# ---------------------------------------------------------------------------
# the lookahead
# ---------------------------------------------------------------------------


@pytest.fixture(params=["native", "numpy"])
def host_path(request, monkeypatch):
    """encoder/lookahead.py through the native library or its NumPy code."""
    native_libs.build()
    native_libs.require()
    if request.param == "numpy":
        from rav1e_tpu_torch import native

        monkeypatch.setattr(native, "get_lib", lambda: None)
    return request.param


SIZES = [(72, 104, 8), (40, 56, 10), (12, 40, 8), (37, 13, 10), (5, 30, 8)]


@pytest.mark.parametrize("h,w,bd", SIZES)
def test_intra_costs_equal_host(host_path, h, w, bd):
    rng = np.random.default_rng(h * w)
    for y in (_plane(rng, h, w, bd),
              _textured(rng, h, w, bd).astype(_plane(rng, 1, 1, bd).dtype),
              np.full((h, w), 97, _plane(rng, 1, 1, bd).dtype)):
        want = la.estimate_intra_costs(y, bd)
        got = fp.la_intra(_t(y), bd)
        assert got.dtype == torch.float64
        np.testing.assert_array_equal(got.numpy(), want)


def _pairs(rng, h, w, bd):
    """(label, src, ref): a pan of up to 30 samples, so the search walks to
    the frame's edge and its candidates leave the frame; a flat plane, where
    every candidate ties; noise."""
    top = (1 << bd) - 1
    dt = np.uint8 if bd == 8 else np.uint16
    base = _textured(rng, h + 64, w + 64, bd, cell=4)
    out = []
    for dy, dx in ((0, 0), (3, -5), (-11, 30), (30, 29)):
        src = base[32: 32 + h, 32: 32 + w]
        ref = base[32 - dy: 32 - dy + h, 32 - dx: 32 - dx + w]
        out.append((f"pan {dy},{dx}", src.astype(dt), ref.astype(dt)))
    out.append(("flat", np.full((h, w), top // 3, dt),
                np.full((h, w), top // 3, dt)))
    out.append(("noise", _plane(rng, h, w, bd), _plane(rng, h, w, bd)))
    return out


@pytest.mark.parametrize("h,w,bd", SIZES)
def test_motion_and_inter_costs_equal_host(host_path, h, w, bd):
    rng = np.random.default_rng(h + w + bd)
    edge = False
    for label, src, ref in _pairs(rng, h, w, bd):
        want_mvs, _ = la.lookahead_motion(src, ref, bd)
        want_inter = la.inter_costs_8x8(want_mvs, src, ref, bd)
        mvs, inter = fp.la_motion(_t(src), _t(ref), bd)
        assert mvs.dtype == torch.int32 and inter.dtype == torch.float64
        np.testing.assert_array_equal(mvs.numpy(), want_mvs, label)
        np.testing.assert_array_equal(inter.numpy(), want_inter, label)
        (mby, mbx), _ = fp.motion_shapes(h, w)
        py = np.arange(mby)[:, None] * 16 + want_mvs[..., 0]
        px = np.arange(mbx)[None, :] * 16 + want_mvs[..., 1]
        edge |= bool(((py == 0) | (px == 0) | (py + 16 == h)
                      | (px + 16 == w)).any() & (want_mvs != 0).any())
        if label == "flat":
            assert not want_mvs.any()
    if min(h, w) >= 16:
        assert edge  # some search stopped at the frame's edge


def test_first_pass_lookahead_packs_one_download():
    """FirstPass.lookahead's grids, laid out in one buffer, are the plain
    versions' (and the host's ones grid on a plane under 8 samples)."""
    for h, w, bd in ((40, 56, 10), (5, 30, 8)):
        rng = np.random.default_rng(h)
        planes = [_textured(rng, h, w, bd, t).astype(
            np.uint8 if bd == 8 else np.uint16) for t in range(4)]
        p = fp.FirstPass("cpu", w, h, bd, keep_luma=True)
        for no, y in enumerate(planes):
            p.upload(10 + no, y)
        pairs = [(10, 11), (11, 13), (12, 13)]
        intra, motion = p.lookahead([10, 11, 12, 13], pairs)
        for no, y in enumerate(planes):
            np.testing.assert_array_equal(intra[10 + no],
                                          la.estimate_intra_costs(y, bd))
        for (s, t), (mvs, inter) in zip(pairs, motion):
            want_mvs, _ = la.lookahead_motion(planes[s - 10], planes[t - 10],
                                              bd)
            np.testing.assert_array_equal(mvs, want_mvs)
            np.testing.assert_array_equal(inter, la.inter_costs_8x8(
                want_mvs, planes[s - 10], planes[t - 10], bd))
        p.release(12)
        assert sorted(p.luma) == [12, 13]


def test_cpu_tensors_launch_nothing():
    kernels.reset_launches()
    y = _t(_plane(np.random.default_rng(1), 40, 48, 8))
    ds = fp.downsample(y)
    fp.scene_sums(ds, ds, ds, 3, True)
    fp.la_intra(y, 8)
    fp.la_motion(y, y, 8)
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)


def _encode(device_pass, nframes=10):
    """Packets of a 64x48 random-access encode with a cut at frame 5,
    through the host functions or through a first pass on the CPU."""
    native_libs.build()
    native_libs.require()
    w, h = 64, 48
    cfg = r.Config(enc=r.EncoderConfig(
        width=w, height=h, quantizer=100,
        speed_settings=r.SpeedSettings.from_preset(6),
        min_key_frame_interval=0, max_key_frame_interval=99), device="cpu")
    ctx = cfg.new_context()
    if device_pass:
        ctx.inner._firstpass = fp.FirstPass("cpu", w, h, 8, keep_luma=True)
    rng = np.random.default_rng(16)
    scenes = [int(rng.integers(1 << 30)) for _ in range(2)]
    pkts, la_groups = [], []
    orig = ctx.inner._lookahead_group

    def spy(group):
        orig(group)
        la_groups.append([g.importances is not None for g in group
                          if g.kind == "inter"])

    ctx.inner._lookahead_group = spy
    for t in range(nframes + 1):
        if t < nframes:
            f = ctx.new_frame()
            y = _textured(np.random.default_rng(scenes[t // 5]), h, w, 8, t,
                          cell=4)
            for i, p in enumerate(f.planes):
                a = y if i == 0 else np.full((p.cfg.height, p.cfg.width), 128)
                a = a + rng.integers(-2, 3, a.shape)
                p.copy_from(np.clip(a, 0, 255).astype(np.uint8))
            ctx.send_frame(f)
        else:
            ctx.flush()
        while True:
            try:
                pkts.append(ctx.receive_packet().data)
            except (r.EncoderStatus.NeedMoreData,
                    r.EncoderStatus.LimitReached):
                break
    if device_pass:
        assert not ctx.inner._firstpass.luma  # every planned luma dropped
    return pkts, sorted(ctx.inner.keyframes), la_groups


def test_first_pass_context_codes_the_hosts_packets():
    from rav1e_tpu_torch.utils import trace

    want = _encode(False)
    trace.trace_enable()
    trace.reset()
    try:
        got = _encode(True)
        names = [e["name"] for e in trace._events]
    finally:
        trace.trace_disable()
        trace.reset()
    # the lookahead's two parts, and one counter a scene detection (10
    # frames) and a group (two)
    assert {"firstpass_upload", "la_costs", "la_propagate"} <= set(names)
    assert names.count("firstpass_card") == 10 + names.count("lookahead")
    assert names.count("lookahead") == 2
    assert got[1] == want[1] == [0, 5]
    assert want[2] and any(any(g) for g in want[2])  # importances attached
    assert got[2] == want[2]
    assert got[0] == want[0]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")


@pytest.mark.card
@pytest.mark.parametrize("h,w", [(1080, 1920), (720, 1280)])
@pytest.mark.parametrize("bd", [8, 10])
def test_kernels_equal_plain_on_the_card(h, w, bd):
    _need_card()
    rng = np.random.default_rng(h + bd)
    planes = [_textured(rng, h, w, bd, t, cell=4) for t in range(3)]
    dt = np.uint8 if bd == 8 else np.uint16
    top = (1 << bd) - 1
    planes = [np.clip(p + rng.integers(-3, 4, p.shape), 0, top).astype(dt)
              for p in planes]
    cpu = [_t(p) for p in planes]
    dev = [c.cuda() for c in cpu]
    ds = [fp.downsample(d) for d in dev]
    torch.cuda.synchronize()
    for d, c in zip(ds, cpu):
        assert torch.equal(d.cpu(), fp.downsample_plain(c))
    r_ = fp.shift_radius(*ds[0].shape)
    for prev2 in (None, ds[0]):
        got = fp.scene_sums(ds[2], ds[1], prev2, r_, True)
        want = fp.scene_sums_plain(ds[2].cpu(), ds[1].cpu(),
                                   None if prev2 is None else prev2.cpu(),
                                   r_, True)
        assert torch.equal(got.cpu(), want)
    for d, c in zip(dev, cpu):
        assert torch.equal(fp.la_intra(d, bd).cpu(), fp.la_intra_plain(c, bd))
    for (s, t) in ((0, 1), (2, 0)):
        mvs, inter = fp.la_motion(dev[s], dev[t], bd)
        want_mvs, want_inter = fp.la_motion_plain(dev[s], dev[t], bd)
        assert torch.equal(mvs, want_mvs)
        assert torch.equal(inter, want_inter)
        # and the native host function
        host_mvs, _ = la.lookahead_motion(planes[s], planes[t], bd)
        np.testing.assert_array_equal(mvs.cpu().numpy(), host_mvs)


@pytest.mark.card
def test_small_planes_on_the_card():
    """Planes a side of which is 1, under 8 or under 16 samples: each kernel
    equals its plain version, and a first pass's scene call equals the
    plain one."""
    _need_card()
    rng = np.random.default_rng(5)
    for h, w, bd in ((1, 9, 8), (9, 1, 10), (5, 30, 8), (12, 40, 10)):
        ys = [_t(_plane(rng, h, w, bd)) for _ in range(3)]
        dev = [y.cuda() for y in ys]
        ds = [fp.downsample(d) for d in dev]
        for d, y in zip(ds, ys):
            assert torch.equal(d.cpu(), fp.downsample_plain(y))
        r_ = fp.shift_radius(*ds[0].shape)
        assert torch.equal(
            fp.scene_sums(ds[2], ds[1], ds[0], r_, True).cpu(),
            fp.scene_sums_plain(ds[2].cpu(), ds[1].cpu(), ds[0].cpu(), r_,
                                True))
        assert torch.equal(fp.la_intra(dev[0], bd).cpu(),
                           fp.la_intra_plain(ys[0], bd))
        got = fp.la_motion(dev[0], dev[1], bd)
        want = fp.la_motion_plain(ys[0], ys[1], bd)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
        p = fp.FirstPass("cuda", w, h, bd, keep_luma=False)
        q = fp.FirstPass("cpu", w, h, bd, keep_luma=False)
        host = [y.numpy().view(np.uint8 if bd == 8 else np.uint16)
                for y in ys]
        c0, _ = p.scene(p.upload(0, host[0]))
        c1, s1 = p.scene(p.upload(1, host[1]), c0, None, True)
        q0, _ = q.scene(q.upload(0, host[0]))
        q1, t1 = q.scene(q.upload(1, host[1]), q0, None, True)
        assert torch.equal(c1.cpu(), q1)
        np.testing.assert_array_equal(s1, t1)


def _card_clip(w, h, n, cut):
    rng = np.random.default_rng(1616)
    scenes = [int(rng.integers(1 << 30)) for _ in range(2)]
    out = []
    for t in range(n):
        y = _textured(np.random.default_rng(scenes[t >= cut]), h, w, 8, t)
        out.append(np.clip(y + rng.integers(-2, 3, y.shape), 0,
                           255).astype(np.uint8))
    return out


def _encode_clip(device, clip, w, h):
    cfg = r.Config(enc=r.EncoderConfig(
        width=w, height=h, quantizer=100,
        speed_settings=r.SpeedSettings.from_preset(6),
        min_key_frame_interval=0, max_key_frame_interval=99), device=device)
    ctx = cfg.new_context()
    pkts = []
    for t in range(len(clip) + 1):
        if t < len(clip):
            f = ctx.new_frame()
            for i, p in enumerate(f.planes):
                a = (clip[t] if i == 0 else
                     np.full((p.cfg.height, p.cfg.width), 128, np.uint8))
                p.copy_from(a)
            ctx.send_frame(f)
        else:
            ctx.flush()
        while True:
            try:
                pkts.append(ctx.receive_packet().data)
            except (r.EncoderStatus.NeedMoreData,
                    r.EncoderStatus.LimitReached):
                break
    return ctx, pkts


@pytest.mark.card
def test_card_encode_equals_cpu_encode():
    """16 frames with reordering and a cut at 9: the card's first pass
    places the CPU's keyframes and the packets are byte for byte the
    CPU's; every scene detection and lookahead group ran its kernels."""
    _need_card()
    w, h = 320, 192
    clip = _card_clip(w, h, 16, 9)
    kernels.reset_launches()
    ctx, got = _encode_clip("cuda", clip, w, h)
    launches = dict(kernels.LAUNCHES)
    cpu_ctx, want = _encode_clip("cpu", clip, w, h)
    assert sorted(ctx.inner.keyframes) == sorted(cpu_ctx.inner.keyframes)
    assert 9 in cpu_ctx.inner.keyframes
    assert got == want
    assert launches["fp_downsample"] == 16
    assert launches["fp_scene_sums"] == 15
    assert launches["fp_la_motion"] > 0 and launches["fp_la_intra"] > 0
    assert not ctx.inner._firstpass.luma


@pytest.mark.card
def test_first_pass_stream_is_its_own():
    """The first pass's stream is neither the capture stream of the graph
    runners, nor the current stream, nor the legacy default stream."""
    _need_card()
    from rav1e_tpu_torch.device import graphs

    dev = torch.device("cuda", torch.cuda.current_device())
    a = fp.FirstPass(dev, 64, 48, 8, keep_luma=True)
    b = fp.FirstPass(dev, 64, 48, 8, keep_luma=True)
    s = a.stream.cuda_stream
    assert s != b.stream.cuda_stream
    assert s not in (graphs._capture_stream(dev).cuda_stream,
                     torch.cuda.current_stream(dev).cuda_stream,
                     torch.cuda.default_stream(dev).cuda_stream, 0)
    assert a.stream.priority < 0
