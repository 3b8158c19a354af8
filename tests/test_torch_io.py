"""rav1e_tpu_torch's io, metrics, activity and fuzzing modules against
rav1e_tpu's on seeded inputs: y4m and IVF round trips in every chroma tag
and bit depth, PSNR exact and SSIM / MS-SSIM to 1e-12 relative, the
activity functions exact, and the fuzz targets on the CPU."""

import io

import numpy as np
import pytest

from rav1e_tpu.io import y4m as ref_y4m
from rav1e_tpu.ops import activity as ref_activity
from rav1e_tpu.utils import metrics as ref_metrics
from rav1e_tpu_torch.io import IvfWriter, Y4MReader, Y4MWriter, read_ivf
from rav1e_tpu_torch.io import y4m as port_y4m
from rav1e_tpu_torch.ops import activity
from rav1e_tpu_torch.utils import fuzzing, metrics
from torch_threads import one_torch_cpu_thread  # noqa: F401


@pytest.mark.parametrize("tag", sorted(port_y4m._COLORSPACES))
def test_y4m_round_trip(tag):
    cs, bd = port_y4m._COLORSPACES[tag]
    ref_cs, ref_bd = ref_y4m._COLORSPACES[tag]
    assert (int(cs), bd) == (int(ref_cs), ref_bd)
    w, h = 35, 19  # odd: chroma rounds up
    rng = np.random.default_rng(len(tag))
    hdr = f"YUV4MPEG2 W{w} H{h} F25:2 Ip A1:1 C{tag}\n".encode()
    dt = np.uint8 if bd == 8 else np.uint16
    reader = Y4MReader(io.BytesIO(hdr))
    dims = [reader._plane_dims(i) for i in range(1 if tag == "mono" else 3)]
    frames = [[rng.integers(0, 1 << bd, (ph, pw)).astype(dt)
               for pw, ph in dims] for _ in range(3)]
    raw = hdr + b"".join(
        b"FRAME\n" + b"".join(p.astype("<u1" if bd == 8 else "<u2").tobytes()
                              for p in f) for f in frames)
    for mod in (port_y4m, ref_y4m):
        got = list(mod.Y4MReader(io.BytesIO(raw)))
        assert len(got) == 3
        for g, want in zip(got, frames):
            assert all(np.array_equal(a, b) and a.dtype == b.dtype
                       for a, b in zip(g, want))
    r = Y4MReader(io.BytesIO(raw))
    assert (r.width, r.height, r.fps_num, r.fps_den, r.bit_depth) == (
        w, h, 25, 2, bd)
    # the writers give the same bytes, which read back to the same frames
    outs = []
    for writer, c in ((Y4MWriter, cs), (ref_y4m.Y4MWriter, ref_cs)):
        out = io.BytesIO()
        wr = writer(out, w, h, 25, 2, c, bd)
        for f in frames:
            wr.write_frame(f)
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    back = list(Y4MReader(io.BytesIO(outs[0])))
    assert len(back) == 3 and all(np.array_equal(a, b) for g, f in
                                  zip(back, frames) for a, b in zip(g, f))


def test_y4m_rejects_bad_streams():
    for raw in (b"", b"NOTY4M W4 H4\n", b"YUV4MPEG2 W4 H4 C411\n",
                b"YUV4MPEG2 H4\n"):
        with pytest.raises(ValueError):
            Y4MReader(io.BytesIO(raw))


def test_ivf_round_trip():
    from rav1e_tpu.io import ivf as ref_ivf

    rng = np.random.default_rng(5)
    frames = [(pts, rng.integers(0, 256, n, dtype=np.uint8).tobytes())
              for pts, n in ((0, 17), (2, 0), (1, 4096), (7, 3))]
    outs = []
    for writer in (IvfWriter, ref_ivf.IvfWriter):
        f = io.BytesIO()
        w = writer(f, 1920, 1080, 30, 1)
        for pts, data in frames:
            w.write_frame(data, pts)
        w.close()
        outs.append(f.getvalue())
    assert outs[0] == outs[1]
    assert int.from_bytes(outs[0][24:28], "little") == len(frames)
    assert list(read_ivf(io.BytesIO(outs[0]))) == frames
    with pytest.raises(ValueError, match="truncated"):
        list(read_ivf(io.BytesIO(outs[0][:-1])))
    with pytest.raises(ValueError, match="not an IVF"):
        list(read_ivf(io.BytesIO(b"XXXX" + outs[0][4:])))


def _planes(seed, bd, shape):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << bd, shape)
    b = np.clip(a + rng.integers(-9, 10, shape), 0, (1 << bd) - 1)
    dt = np.uint8 if bd == 8 else np.uint16
    return a.astype(dt), b.astype(dt)


@pytest.mark.parametrize("bd,shape", [(8, (64, 96)), (10, (37, 53)),
                                      (12, (130, 70)), (8, (7, 40))])
def test_metrics_match_reference(bd, shape):
    a, b = _planes(bd + shape[0], bd, shape)
    assert metrics.psnr(a, b, bd) == ref_metrics.psnr(a, b, bd)
    assert metrics.psnr(a, a, bd) == ref_metrics.psnr(a, a, bd)
    for fn in ("ssim", "ms_ssim"):
        got = getattr(metrics, fn)(a, b, bd)
        want = getattr(ref_metrics, fn)(a, b, bd)
        assert got == pytest.approx(want, rel=1e-12, abs=0)
    src = [a, a[: shape[0] // 2, : shape[1] // 2], b[: shape[0] // 2]]
    rec = [b, b[: shape[0] // 2, : shape[1] // 2], a[: shape[0] // 2]]
    got = metrics.frame_metrics(src, rec, bd)
    want = ref_metrics.frame_metrics(src, rec, bd)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0), k


@pytest.mark.parametrize("bd,shape", [(8, (64, 80)), (10, (45, 23)),
                                      (12, (7, 5))])
def test_activity_matches_reference(bd, shape):
    luma = _planes(bd * shape[1], bd, shape)[0]
    got = activity.activity_mask(luma, bd)
    want = ref_activity.activity_mask(luma, bd)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(activity.log2_activity_scale(got),
                                  ref_activity.log2_activity_scale(want))
    for sv, dv in ((0.0, 0.0), (12.5, 3.0), (900.0, 1e4)):
        assert activity.ssim_boost(sv, dv, bd) == ref_activity.ssim_boost(
            sv, dv, bd)


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_construct_context(seed):
    """Random configs construct or raise InvalidConfig on the CPU, as the
    reference's do: the same seed is accepted or refused by both."""
    from rav1e_tpu.utils import fuzzing as ref_fuzzing

    assert fuzzing.fuzz_construct_context(seed, "cpu") == (
        ref_fuzzing.fuzz_construct_context(seed))


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_encode_decode(seed):
    """Random valid configs encode on the CPU and every packet decodes to
    its reconstruction through the port's decoder."""
    assert fuzzing.fuzz_encode_decode(seed, "cpu") >= 1
