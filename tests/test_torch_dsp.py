"""rav1e_tpu_torch.device.dsp against rav1e_tpu.device.dsp: the same seeded
numpy inputs through both, exactly equal outputs (motion compensation,
forward transform, quantizer, dequantize + inverse transform, deblocking).
Also the port's torch inverse-transform interpreter against its numpy one.
The cases mirror tests/test_device_dsp.py, at small batches."""

import numpy as np
import pytest
import torch
from torch_threads import one_torch_cpu_thread  # noqa: F401

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from rav1e_tpu.device import dsp as rdsp  # noqa: E402
from rav1e_tpu.ops import transforms as rtf  # noqa: E402
from rav1e_tpu.quantize import QuantizationContext, _scan_u16  # noqa: E402
from rav1e_tpu.tx import TxSize as RTxSize, TxType as RTxType  # noqa: E402
from rav1e_tpu_torch.device import dsp  # noqa: E402
from rav1e_tpu_torch.ops import transforms as tf  # noqa: E402
from rav1e_tpu_torch.tx import TxSize, TxType  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=msg)


def _plane(rng, h, w, pad, bd):
    return rng.integers(0, 1 << bd, (h + 2 * pad, w + 2 * pad)).astype(np.int32)


# ---------------------------------------------------------------------------
# motion compensation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("h,w", [(8, 8), (16, 16), (8, 16), (4, 4), (32, 32)])
def test_mc_put(bd, h, w):
    rng = np.random.default_rng(100 * h + w + bd)
    pad, n = 32, 12
    ref = _plane(rng, 64, 64, pad, bd)
    pos_y = rng.integers(0, 48, n).astype(np.int32)
    pos_x = rng.integers(0, 48, n).astype(np.int32)
    mv_r = rng.integers(-12 * 8, 12 * 8, n).astype(np.int32)
    mv_c = rng.integers(-12 * 8, 12 * 8, n).astype(np.int32)
    want = rdsp.mc_put_batched(jnp.asarray(ref), pad, jnp.asarray(pos_y),
                               jnp.asarray(pos_x), jnp.asarray(mv_r),
                               jnp.asarray(mv_c), h, w, bd)
    got = dsp.mc_put_batched(_t(ref), pad, _t(pos_y), _t(pos_x), _t(mv_r),
                             _t(mv_c), h, w, bd)
    assert got.dtype == torch.int32
    _eq(got, want)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("h,w", [(4, 4), (8, 8), (16, 16)])
def test_mc_put_chroma_decimated(bd, h, w):
    """Chroma planes: luma MVs with 4:2:0 decimation (xdec = ydec = 1)."""
    rng = np.random.default_rng(7 + bd + h)
    pad, n = 32, 12
    ref = _plane(rng, 40, 40, pad, bd)
    pos_y = rng.integers(0, 24, n).astype(np.int32)
    pos_x = rng.integers(0, 24, n).astype(np.int32)
    mv_r = rng.integers(-10 * 8, 10 * 8, n).astype(np.int32)
    mv_c = rng.integers(-10 * 8, 10 * 8, n).astype(np.int32)
    want = rdsp.mc_put_batched(jnp.asarray(ref), pad, jnp.asarray(pos_y),
                               jnp.asarray(pos_x), jnp.asarray(mv_r),
                               jnp.asarray(mv_c), h, w, bd, xdec=1, ydec=1)
    got = dsp.mc_put_batched(_t(ref), pad, _t(pos_y), _t(pos_x), _t(mv_r),
                             _t(mv_c), h, w, bd, xdec=1, ydec=1)
    _eq(got, want)


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("dec", [0, 1])
def test_mc_compound(bd, dec):
    """prep_8tap of two references through a per-block reference select,
    then the compound average."""
    rng = np.random.default_rng(bd * 3 + dec)
    pad, n, h, w = 32, 10, 16 >> dec, 16 >> dec
    refs = np.stack([_plane(rng, 48, 48, pad, bd) for _ in range(3)])
    pos_y = rng.integers(0, 30, n).astype(np.int32)
    pos_x = rng.integers(0, 30, n).astype(np.int32)
    mv = rng.integers(-8 * 8, 8 * 8, (n, 4)).astype(np.int32)
    ridx = rng.integers(0, 3, (2, n)).astype(np.int32)

    def both(k):
        mr, mc_ = mv[:, 2 * k], mv[:, 2 * k + 1]
        iy0 = pad + pos_y + (mr >> (3 + dec)) - 3
        ix0 = pad + pos_x + (mc_ >> (3 + dec)) - 3
        rw = rdsp.mc_gather_windows_ref(
            jnp.asarray(refs), jnp.asarray(ridx[k]), jnp.asarray(iy0),
            jnp.asarray(ix0), h, w)
        tw = dsp.mc_gather_windows_ref(_t(refs), _t(ridx[k]), _t(iy0),
                                       _t(ix0), h, w)
        _eq(tw, rw, "windows")
        rp = rdsp.mc_prep_from_windows(rw, jnp.asarray(mr), jnp.asarray(mc_),
                                       h, w, bd, dec, dec)
        tp = dsp.mc_prep_from_windows(tw, _t(mr), _t(mc_), h, w, bd, dec, dec)
        _eq(tp, rp, "prep")
        return tp, rp

    (t0, r0), (t1, r1) = both(0), both(1)
    _eq(dsp.mc_avg(t0, t1, bd), rdsp.mc_avg(r0, r1, bd))


def test_mc_gather_windows_uint8():
    """Windows from a uint8 plane widen to int32, as the reference's do."""
    rng = np.random.default_rng(3)
    ref = rng.integers(0, 256, (96, 160)).astype(np.uint8)
    iy0 = rng.integers(0, 80, 40).astype(np.int32)
    ix0 = rng.integers(0, 144, 40).astype(np.int32)
    got = dsp.mc_gather_windows(_t(ref), _t(iy0), _t(ix0), 8, 8)
    assert got.dtype == torch.int32
    _eq(got, rdsp.mc_gather_windows(jnp.asarray(ref), jnp.asarray(iy0),
                                    jnp.asarray(ix0), 8, 8))


# ---------------------------------------------------------------------------
# transform + quantizer
# ---------------------------------------------------------------------------

TX_CASES = [
    ("TX_4X4", "DCT_DCT"),
    ("TX_8X8", "DCT_DCT"),
    ("TX_16X16", "DCT_DCT"),
    ("TX_32X32", "DCT_DCT"),
    ("TX_64X64", "DCT_DCT"),
    ("TX_8X16", "DCT_DCT"),
    ("TX_16X8", "DCT_DCT"),
    ("TX_8X8", "ADST_ADST"),
]


def _tx(name, kind):
    return (TxSize[name], TxType[kind]), (RTxSize[name], RTxType[kind])


@pytest.mark.parametrize("name,kind", TX_CASES)
def test_fwd_tx(name, kind):
    (ts, tt), (rts, rtt) = _tx(name, kind)
    rng = np.random.default_rng(len(name) + len(kind))
    res = rng.integers(-510, 511, (6, ts.height, ts.width)).astype(np.int32)
    got = dsp.fwd_tx_batched(_t(res), ts, tt)
    assert got.dtype == torch.int32
    _eq(got, rdsp.fwd_tx_batched(jnp.asarray(res), rts, rtt))


@pytest.mark.parametrize("name,kind", TX_CASES)
@pytest.mark.parametrize("is_intra", [False, True])
def test_quantize_scan_to_dense(name, kind, is_intra):
    (ts, tt), (rts, rtt) = _tx(name, kind)
    rng = np.random.default_rng(11 + len(name))
    res = rng.integers(-510, 511, (6, ts.height, ts.width)).astype(np.int32)
    coeffs = rtf.forward_transform(res, rts, rtt, 8)
    qc = QuantizationContext()
    qc.update(120, rts, is_intra, 8)
    scan = _scan_u16(min(ts.width, 32), min(ts.height, 32), "default")
    rl, re = rdsp.quantize_batched(jnp.asarray(coeffs), rts, scan,
                                   qc.dc_quant, qc.ac_quant, is_intra)
    tl, te = dsp.quantize_batched(_t(coeffs), ts, scan, qc.dc_quant,
                                  qc.ac_quant, is_intra)
    _eq(tl, rl, "levels")
    _eq(te, re, "eob")
    _eq(dsp.scan_to_dense(tl, ts, scan), rdsp.scan_to_dense(rl, rts, scan))


@pytest.mark.parametrize("per_block_q", [False, True])
def test_quantize_per_block_q(per_block_q):
    """Segmentation: per-block quantizers."""
    from rav1e_tpu import tables

    rng = np.random.default_rng(5)
    ts, rts = TxSize.TX_16X16, RTxSize.TX_16X16
    res = rng.integers(-510, 511, (6, 16, 16)).astype(np.int32)
    coeffs = rtf.forward_transform(res, rts, RTxType.DCT_DCT, 8)
    scan = _scan_u16(16, 16, "default")
    qidx = rng.integers(80, 180, 6) if per_block_q else np.full(6, 120)
    dcq = np.array([tables.dc_q(int(q), 0, 8) for q in qidx], dtype=np.int32)
    acq = np.array([tables.ac_q(int(q), 0, 8) for q in qidx], dtype=np.int32)
    rl, re = rdsp.quantize_batched(jnp.asarray(coeffs), rts, scan,
                                   jnp.asarray(dcq), jnp.asarray(acq), False)
    tl, te = dsp.quantize_batched(_t(coeffs), ts, scan, _t(dcq), _t(acq),
                                  False)
    _eq(tl, rl)
    _eq(te, re)


@pytest.mark.parametrize("name,kind", TX_CASES)
def test_itx_recon(name, kind):
    (ts, tt), (rts, rtt) = _tx(name, kind)
    rng = np.random.default_rng(23 + len(name))
    h, w = ts.height, ts.width
    res = rng.integers(-200, 201, (5, h, w)).astype(np.int32)
    coeffs = rtf.forward_transform(res, rts, rtt, 8)
    qc = QuantizationContext()
    qc.update(100, rts, False, 8)
    scan = _scan_u16(min(w, 32), min(h, 32), "default")
    levels, _ = rdsp.quantize_batched(jnp.asarray(coeffs), rts, scan,
                                      qc.dc_quant, qc.ac_quant, False)
    qdense = np.asarray(rdsp.scan_to_dense(levels, rts, scan))
    pred = rng.integers(0, 256, (5, h, w)).astype(np.int32)
    want = rdsp.itx_add_batched(jnp.asarray(qdense), jnp.asarray(pred), rts,
                                rtt, 8, qc.dc_quant, qc.ac_quant)
    got = dsp.itx_add_batched(_t(qdense), _t(pred), ts, tt, 8, qc.dc_quant,
                              qc.ac_quant)
    assert got.dtype == torch.int32
    _eq(got, want)


@pytest.mark.parametrize("name", ["TX_4X4", "TX_8X8", "TX_16X16", "TX_32X32",
                                  "TX_64X64"])
def test_itx_extreme_levels_wrap(name):
    """The chain's tx sizes with levels far beyond any codeable stream: the
    dequantizer's int32 product and the butterflies wrap, and the port
    wraps exactly as the reference does."""
    (ts, tt), (rts, rtt) = _tx(name, "DCT_DCT")
    rng = np.random.default_rng(31 + ts.width)
    h, w = ts.height, ts.width
    q = np.zeros((4, h, w), dtype=np.int32)
    ch, cw = min(h, 32), min(w, 32)
    q[:, :ch, :cw] = rng.integers(-(1 << 24), 1 << 24, (4, ch, cw))
    q[0, :ch, :cw] = (1 << 31) - 1
    q[1, :ch, :cw] = -(1 << 31)
    dcq = np.array([4, 1336, 777, 5247], dtype=np.int32)
    acq = np.array([4, 1828, 1001, 5247], dtype=np.int32)
    pred = rng.integers(0, 256, (4, h, w)).astype(np.int32)
    want = rdsp.itx_add_batched(jnp.asarray(q), jnp.asarray(pred), rts, rtt,
                                8, jnp.asarray(dcq), jnp.asarray(acq))
    got = dsp.itx_add_batched(_t(q), _t(pred), ts, tt, 8, _t(dcq), _t(acq))
    _eq(got, want)


@pytest.mark.parametrize("name,kind", [
    ("TX_4X4", "ADST_FLIPADST"), ("TX_8X8", "FLIPADST_DCT"),
    ("TX_16X16", "ADST_ADST"), ("TX_16X8", "IDTX"), ("TX_32X32", "IDTX"),
    ("TX_4X4", "WHT_WHT"), ("TX_64X64", "DCT_DCT"), ("TX_16X64", "DCT_DCT"),
])
@pytest.mark.parametrize("bd", [8, 10])
def test_inverse_transform_torch_equals_numpy(name, kind, bd):
    """The port's level-by-level torch interpreter against its own numpy
    interpreter (the op-by-op program walk) for every kind of program."""
    ts, tt = TxSize[name], TxType[kind]
    rng = np.random.default_rng(bd + len(name) * 7 + len(kind))
    h, w = ts.height, ts.width
    c = np.zeros((3, h, w), dtype=np.int32)
    lim = 1 << (bd + 8)
    c[:, : min(h, 32), : min(w, 32)] = rng.integers(
        -lim, lim, (3, min(h, 32), min(w, 32)))
    pred = rng.integers(0, 1 << bd, (3, h, w)).astype(np.int32)
    tf_np = tf.inverse_transform_residual(c, ts, tt, bd)
    got = tf.inverse_transform_residual(_t(c), ts, tt, bd)
    _eq(got, tf_np)
    want = np.clip(pred + tf_np, 0, (1 << bd) - 1)
    _eq(tf.inverse_transform_add(_t(c), _t(pred), ts, tt, bd), want)


# ---------------------------------------------------------------------------
# deblock
# ---------------------------------------------------------------------------


def _random_blocks(mi_rows, mi_cols, rng):
    """8x8 / 16x16 partitions with random tx sizes, skips and refs (the
    blocks of tests/test_device_dsp.py)."""
    from rav1e_tpu.context.block import FrameBlocks

    fb = FrameBlocks(mi_cols, mi_rows)
    y = 0
    while y < mi_rows:
        x = 0
        step_y = 4 if (y % 8 == 0 and rng.integers(2)) else 2
        while x < mi_cols:
            step = min(step_y, mi_cols - x, mi_rows - y)
            if step >= 4:
                bsize, txs = 6, int(rng.choice([4, 1]))
            else:
                bsize, txs = 3, int(rng.choice([1, 0]))
            fb.bsize[y:y + step, x:x + step] = bsize
            fb.tx_size[y:y + step, x:x + step] = txs
            fb.skip[y:y + step, x:x + step] = int(rng.integers(2))
            fb.ref_frames[y:y + step, x:x + step, 0] = int(rng.integers(2))
            fb.ref_frames[y:y + step, x:x + step, 1] = -1
            x += step
        y += step_y
    return fb


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("pli,dec", [(0, 0), (1, 1)])
@pytest.mark.parametrize("vertical", [True, False])
def test_deblock_pass(bd, pli, dec, vertical):
    """One pass of each orientation, luma and chroma, against the
    reference's pass and the host oracle's edge decisions; the level comes
    as a 0-d tensor, as the chain passes it."""
    from rav1e_tpu.ops.deblock import _plane_edge_decisions

    rng = np.random.default_rng(7 + bd + pli)
    mi_rows, mi_cols = 24, 32
    fb = _random_blocks(mi_rows, mi_cols, rng)
    ph, pw = (mi_rows * 4) >> dec, (mi_cols * 4) >> dec
    pad = 8
    plane = rng.integers(0, 1 << bd, (ph + 2 * pad, pw + 2 * pad)).astype(np.int32)
    # a smooth ramp on a third of the rows reaches the flat (wide) filters
    plane[pad : pad + ph // 3] = (np.arange(pw + 2 * pad) * 3 % (1 << bd))[None]
    levels = [32, 32, 24, 20]
    level = levels[0 if vertical else 1] if pli == 0 else levels[pli + 1]
    sizes = _plane_edge_decisions(fb, pli, dec, dec, pw >> 2, ph >> 2,
                                  vertical).astype(np.int32)
    if vertical:
        sizes[:, 0] = 0
    else:
        sizes[0, :] = 0
    want = rdsp.deblock_pass_device(jnp.asarray(plane), jnp.asarray(sizes),
                                    level, bd, vertical)
    src = _t(plane)
    got = dsp.deblock_pass_device(src, _t(sizes),
                                  torch.tensor(level, dtype=torch.int32), bd,
                                  vertical)
    _eq(got, want)
    # the plain version of csrc/deblock.cu, which a CPU tensor takes
    _eq(dsp.deblock_pass_plain(src, _t(sizes), level, bd, vertical), want)
    _eq(src, plane, "the input plane was written")
    assert not np.array_equal(np.asarray(want), plane)


def test_deblock_groups14():
    rng = np.random.default_rng(9)
    n = 64
    base = rng.integers(60, 80, (n, 1, 1))
    g = (base + rng.integers(-3, 4, (n, 4, 14))).astype(np.int32)
    fsize = rng.choice([0, 4, 6, 8, 14], n).astype(np.int32)
    want = rdsp.deblock_groups14(jnp.asarray(g), 40, 8, jnp.asarray(fsize))
    _eq(dsp.deblock_groups14(_t(g), 40, 8, _t(fsize)), want)
