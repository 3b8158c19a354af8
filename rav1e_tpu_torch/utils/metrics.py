"""Quality metrics (PSNR / APSNR / SSIM / MS-SSIM).

Counterpart of the reference CLI's av-metrics integration
(reference src/bin/stats.rs: PSNR, APSNR, SSIM, MS-SSIM).  Vectorized
numpy; shapes map directly to batched device reductions.
"""

from __future__ import annotations

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, bd: int = 8) -> float:
    mx = (1 << bd) - 1
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    if mse <= 0:
        return float("inf")
    return 10.0 * np.log10(mx * mx / mse)


def _ssim_maps(a: np.ndarray, b: np.ndarray, bd: int):
    """Per-pixel SSIM map with an 8x8 box window (av-metrics style)."""
    from numpy.lib.stride_tricks import sliding_window_view

    mx = (1 << bd) - 1
    c1 = (0.01 * mx) ** 2
    c2 = (0.03 * mx) ** 2
    af = a.astype(np.float64)
    bf = b.astype(np.float64)
    k = 8
    if af.shape[0] < k or af.shape[1] < k:
        k = min(af.shape)
    wa = sliding_window_view(af, (k, k))
    wb = sliding_window_view(bf, (k, k))
    mua = wa.mean(axis=(2, 3))
    mub = wb.mean(axis=(2, 3))
    va = wa.var(axis=(2, 3))
    vb = wb.var(axis=(2, 3))
    cov = (wa * wb).mean(axis=(2, 3)) - mua * mub
    num = (2 * mua * mub + c1) * (2 * cov + c2)
    den = (mua**2 + mub**2 + c1) * (va + vb + c2)
    return num / den


def ssim(a: np.ndarray, b: np.ndarray, bd: int = 8) -> float:
    return float(_ssim_maps(a, b, bd).mean())


def ms_ssim(a: np.ndarray, b: np.ndarray, bd: int = 8, levels: int = 5) -> float:
    """Multi-scale SSIM (standard 5-level weights)."""
    weights = [0.0448, 0.2856, 0.3001, 0.2363, 0.1333][:levels]
    vals = []
    af, bf = a.astype(np.float64), b.astype(np.float64)
    for i, wgt in enumerate(weights):
        if min(af.shape) < 8:
            break
        vals.append((max(ssim(af, bf, bd), 1e-6), wgt))
        if i < len(weights) - 1:
            h2, w2 = (af.shape[0] // 2) * 2, (af.shape[1] // 2) * 2
            af = af[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2).mean(axis=(1, 3))
            bf = bf[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2).mean(axis=(1, 3))
    total_w = sum(w for _, w in vals)
    out = 1.0
    for v, wgt in vals:
        out *= v ** (wgt / total_w)
    return float(out)


def frame_metrics(src_planes, rec_planes, bd: int = 8) -> dict:
    """All metrics for one frame: per-plane PSNR + luma SSIM/MS-SSIM."""
    out = {}
    names = ["y", "u", "v"]
    for i, (s, r) in enumerate(zip(src_planes, rec_planes)):
        out[f"psnr_{names[i]}"] = psnr(s, r, bd)
    out["ssim_y"] = ssim(src_planes[0], rec_planes[0], bd)
    out["ms_ssim_y"] = ms_ssim(src_planes[0], rec_planes[0], bd)
    return out
