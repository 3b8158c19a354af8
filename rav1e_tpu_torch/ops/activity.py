"""Activity masking / psychovisual scales.

Counterpart of the reference's ``src/activity.rs`` (8x8 source variance →
``ActivityMask``, ``ssim_boost`` distortion scaling).  Vectorized over the
whole plane — on device this is one reshape+reduce pass.
"""

from __future__ import annotations

import numpy as np


def activity_mask(luma: np.ndarray, bd: int = 8) -> np.ndarray:
    """Per-8x8 variance of the source luma (activity.rs:23-60).

    Returns (H//8, W//8) float64 variance, normalized to 8-bit scale.
    """
    h, w = luma.shape
    h8, w8 = h // 8, w // 8
    if h8 == 0 or w8 == 0:
        return np.ones((max(h8, 1), max(w8, 1)))
    x = luma[: h8 * 8, : w8 * 8].astype(np.float64) / (1 << (bd - 8))
    blocks = x.reshape(h8, 8, w8, 8)
    mean = blocks.mean(axis=(1, 3), keepdims=True)
    return ((blocks - mean) ** 2).mean(axis=(1, 3))


def ssim_boost(svar: float, dvar: float, bd: int) -> float:
    """SSIM-style distortion boost (activity.rs:148-180 behavioral analog)."""
    c2 = (0.03 * ((1 << bd) - 1)) ** 2
    return (2.0 * (svar * dvar) ** 0.5 + c2) / (svar + dvar + c2)


def log2_activity_scale(act: np.ndarray) -> np.ndarray:
    """log2 of the sqrt-activity scale used for segment clustering
    (counterpart of spatiotemporal-score blog16, segmentation.rs)."""
    return 0.5 * np.log2(np.maximum(act, 1.0))
