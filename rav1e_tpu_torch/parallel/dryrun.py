"""The multi-device dry run: the sharded analysis, the rate controller that
reads its psum, and an encode through the public API on a mesh.

Counterpart of ``__graft_entry__.dryrun_multichip``.  It takes the devices
to run on, CUDA slots or CPU slots, where the reference forces XLA's CPU
platform; every check raises ``AssertionError``.
"""

from __future__ import annotations

import numpy as np
import torch

from rav1e_tpu_torch.parallel.mesh import (
    ME_HALO,
    make_mesh,
    sharded_frame_analysis,
    sharded_inter_analysis,
)


def _equal(a, b, what):
    assert np.array_equal(np.asarray(a), np.asarray(b)), what


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run the real device stage over an n-slot mesh (the visible cards, or
    ``devices``): per-band intra and inter analysis held against each band
    analysed alone on the first slot, the two psum'd rate estimates fed to
    the rate controller, and a 3-frame ``Context`` encode whose packets
    must be the same with the mesh as without it.  Returns the packets and
    the two estimates."""
    from rav1e_tpu_torch.api.util import FrameType
    from rav1e_tpu_torch.device import analysis
    from rav1e_tpu_torch.rc import RCState

    mesh = make_mesh(n_devices, devices=devices)
    n = mesh.size
    dev0 = mesh.devices[0]
    band_h = 64  # one superblock row per slot
    h, w = n * band_h, 4 * 64
    rng = np.random.default_rng(1)
    luma = rng.integers(0, 256, (h, w), dtype=np.int32)
    qindex, lam, bd = 110, 30.0, 8
    q, lam_t = analysis._scalars(qindex, lam, bd, dev0)

    def alone(*planes, has_inter):
        t = [torch.from_numpy(np.ascontiguousarray(p)).to(dev0)
             for p in planes]
        return analysis._frame_analysis(t[0], t[-1], t[-1], t[-1], q, lam_t,
                                        bd, has_inter=has_inter)

    # intra: each band is an independent tile band (no intra prediction
    # across tile edges in AV1), so it equals the band analysed alone
    size_map, mode_map, _inter, bits = sharded_frame_analysis(
        mesh, luma, qindex, lam, bd)
    assert size_map.shape == (h // 8, w // 8)
    assert np.isfinite(bits) and bits > 0
    for i in range(n):
        lo, hi = i * band_h, (i + 1) * band_h
        s_ref, m_ref, *_ = alone(luma[lo:hi], has_inter=False)
        c = slice(lo // 8, hi // 8)
        _equal(s_ref.cpu(), size_map[c], f"band {i} intra size map")
        _equal(m_ref.cpu(), mode_map[c], f"band {i} intra mode map")

    # inter: ME pyramid + subpel + cost fields per band, the halo exchange of
    # source and reference edge rows, the psum of the interior rates
    ref = np.roll(luma, (2, -5), (0, 1)).astype(np.int32)
    s2, m2, i2, mv0, bits2 = sharded_inter_analysis(
        mesh, luma, ref, qindex, lam, bd)
    assert s2.shape == (h // 8, w // 8)
    assert mv0.shape == (h // 16, w // 16, 2)
    assert np.isfinite(bits2) and bits2 > 0
    assert bool(i2.any()), "inter never chosen on translating content"
    Hh = ME_HALO
    for i in range(n):
        lo, hi = i * band_h, (i + 1) * band_h

        def ext(p):
            top = p[lo - Hh : lo] if i > 0 else np.repeat(p[:1], Hh, 0)
            bot = p[hi : hi + Hh] if i < n - 1 else np.repeat(p[-1:], Hh, 0)
            return np.concatenate([top, p[lo:hi], bot])

        s_ref, m_ref, i_ref, _b, mv_ref, *_ = alone(ext(luma), ext(ref),
                                                    has_inter=True)
        c = slice(Hh // 8, Hh // 8 + band_h // 8)
        m = slice(Hh // 16, Hh // 16 + band_h // 16)
        _equal(s_ref[c].cpu(), s2[lo // 8 : hi // 8], f"band {i} size map")
        _equal(m_ref[c].cpu(), m2[lo // 8 : hi // 8], f"band {i} mode map")
        _equal(i_ref[c].cpu(), i2[lo // 8 : hi // 8], f"band {i} inter map")
        _equal(mv_ref[m].cpu(), mv0[lo // 16 : hi // 16], f"band {i} MVs")

    # the consumer of the allreduce: the psum'd estimates drive the reservoir
    rc = RCState(bit_depth=bd, quantizer=100, bitrate=1_000_000,
                 framerate=30.0)
    qi = rc.select_qi(FrameType.KEY, w, h)
    rc.update_state(int(bits), FrameType.KEY, qi, w, h)
    qi2 = rc.select_qi(FrameType.INTER, w, h)
    rc.update_state(int(bits2), FrameType.INTER, qi2, w, h)
    assert 0 < rc.select_qi(FrameType.INTER, w, h) <= 255

    # the public API on the mesh: Context.send_frame / receive_packet with
    # every frame's analysis sharded over the slots, one band per slot
    sharded = _encode_clip(mesh, dev0, h)
    single = _encode_clip(None, dev0, h)
    assert len(sharded) == 3 and sharded == single, (
        "mesh-sharded Context encode diverged from the unsharded one")
    return {"packets": sharded, "bits": (bits, bits2)}


def _encode_clip(mesh, device, h: int, w: int = 128):
    """3 frames of a panning texture at speed 8 on ``device``, chain off
    (the mesh wiring under test is the analysis'), with the analysis mesh
    swapped for ``mesh`` (None: unsharded) for the encode's duration."""
    import rav1e_tpu_torch as r
    from rav1e_tpu_torch.device import analysis

    ss = r.SpeedSettings.from_preset(8)
    ss.device_chain = False
    cfg = r.Config(enc=r.EncoderConfig(width=w, height=h, quantizer=120,
                                       low_latency=True, speed_settings=ss),
                   device=str(device))
    rng = np.random.default_rng(7)
    base = rng.integers(0, 256, (h, w)).astype(np.uint8)
    orig = analysis._analysis_mesh
    analysis._analysis_mesh = lambda _device: mesh
    try:
        ctx = cfg.new_context()
        for t in range(3):
            f = ctx.new_frame()
            for i, p in enumerate(f.planes):
                if i == 0:
                    arr = np.roll(base, 2 * t, axis=1)
                else:
                    arr = np.full((p.cfg.height, p.cfg.width), 128, np.uint8)
                p.copy_from(arr)
            ctx.send_frame(f)
        ctx.flush()
        pkts = []
        while True:
            try:
                pkts.append(ctx.receive_packet().data)
            except r.EncoderStatus.LimitReached:
                return pkts
    finally:
        analysis._analysis_mesh = orig
