"""The encoder's constant tables, carried across from the JAX reference.

The encoder has no weights: its parameters are constant tables.  Two kinds
live here.

- The small numpy plans that ``rav1e_tpu.device.*`` keeps in its own
  modules, which import JAX; this module holds its own copies
  (``tests/test_torch_encode.py`` holds every copy equal to the
  reference's).
- :func:`from_reference`, which builds the port's tensors on a device from
  the port's own numpy host modules (``ops/``, ``tables``: copies of
  ``rav1e_tpu``'s).
  :func:`on` caches one such set per device.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from rav1e_tpu_torch.ops.cdef import CDEF_UV_DIR_422, _partial_matrices
from rav1e_tpu_torch.ops.intra import (
    DR_INTRA_DERIVATIVE,
    SM_WEIGHTS,
    select_ief_strength,
    select_ief_upsample,
)

# --- device/analysis.py:37-50 ----------------------------------------------

SIZE_LOG2S = (3, 4, 5, 6)  # analysis partition sizes 8x8 .. 64x64
N_MODES = 13  # PredictionMode 0..12 (everything except UV_CFL)
HDR_BITS = 7.0  # estimated header bits per coded block
SPLIT_BITS = 2.5
MODE_BITS = np.array(
    [1.5, 3.0, 3.0, 4.5, 4.5, 4.5, 4.5, 4.5, 4.5, 3.5, 4.0, 4.0, 3.0],
    dtype=np.float32,
)
INTER_BITS = 9.0  # ref + inter mode + mvd estimate

# --- device/me.py:32, :153, :263-269 ----------------------------------------

ME_BLOCK = 16
SUBPEL_OFFS = (-6, -4, -2, 0, 2, 4, 6)  # 1/8-pel offsets of the subpel grid
L2_CLIP = 8  # quarter-res px after the L2 rounds
L1_CLIP = 18  # half-res px seed bound (2*8 + 2)
L0_CLIP = 38  # full-res px bound (2*18 + 2)
PAD_L2 = L2_CLIP + 3 * 2 + 1 + 2  # seed + R*step + margin
PAD_L1 = L1_CLIP + 2 + 2
PAD_L0 = L0_CLIP + 2 + 4 + 2  # + subpel window margin (4)


@functools.lru_cache(None)
def subpel_variants():
    """(int_shift, frac16) per 1/8-pel offset (mv_to_offsets semantics)."""
    return tuple((o >> 3, (o << 1) & 0xF) for o in SUBPEL_OFFS)


# --- device/analysis.py:64-202: directional-prediction index plans --------

EDGE_KERNELS = ((0, 4, 8, 4, 0), (0, 5, 6, 5, 0), (2, 4, 4, 4, 2))


@functools.lru_cache(None)
def ief_static(s: int, p_angle: int):
    """Static intra-edge-filter config of a square s-block directional mode
    at angle_delta=0, smooth_filter=False (spec 7.11.2.9/.10).

    Returns (st_above, st_left, ups_above, ups_left, num_above, num_left)
    where num_* counts edge SAMPLES (excl. the top-left at buffer index 0).
    """
    st_a = select_ief_strength(s, s, False, p_angle - 90)
    st_l = select_ief_strength(s, s, False, p_angle - 180)
    ups_a = select_ief_upsample(s, s, False, p_angle - 90)
    ups_l = select_ief_upsample(s, s, False, p_angle - 180)
    num_a = s + (s if p_angle < 90 else 0)
    num_l = s + (s if p_angle > 180 else 0)
    return st_a, st_l, ups_a, ups_l, num_a, num_l


@functools.lru_cache(None)
def filter_idx(L: int, num: int):
    """5-tap edge-filter gather indices (taps clamped to [0, num-1]) and the
    mask of filtered positions 1..num-1 over a length-L buffer."""
    idx = np.arange(L)
    mats = tuple(
        np.clip(idx - 2 + j, 0, num - 1).astype(np.int32) for j in range(5)
    )
    valid = (idx >= 1) & (idx < num)
    return mats, valid


@functools.lru_cache(None)
def dir_plan(s: int, p_angle: int, ua: int, ul: int, La: int, Ll: int):
    """Static gather indices / blend shifts of the directional predictor
    (spec 7.11.2.4 steps 4-9) over filtered/upsampled edge buffers of
    lengths La/Ll, exactly mirroring ops/intra._pred_directional."""
    ii, jj = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
    off_a, off_l = 1 << ua, 1 << ul
    if p_angle < 90:
        dx = DR_INTRA_DERIVATIVE[p_angle]
        idx = (ii + 1) * dx
        base = (idx >> (6 - ua)) + (jj << ua)
        shift = ((idx << ua) >> 1) & 31
        max_base = (2 * s - 1) << ua
        basec = np.minimum(base, max_base)
        return (
            "above",
            (off_a + basec).astype(np.int32),
            (off_a + np.minimum(basec + 1, max_base)).astype(np.int32),
            shift.astype(np.int32),
            (base < max_base),
            off_a + max_base,
        )
    if p_angle > 180:
        dy = DR_INTRA_DERIVATIVE[270 - p_angle]
        idx = (jj + 1) * dy
        base = (idx >> (6 - ul)) + (ii << ul)
        shift = ((idx << ul) >> 1) & 31
        max_base = (2 * s - 1) << ul
        basec = np.minimum(base, max_base)
        return (
            "left",
            (off_l + basec).astype(np.int32),
            (off_l + np.minimum(basec + 1, max_base)).astype(np.int32),
            shift.astype(np.int32),
            None,
            None,
        )
    # 90 < angle < 180: mix of above and left
    dx = DR_INTRA_DERIVATIVE[180 - p_angle]
    dy = DR_INTRA_DERIVATIVE[p_angle - 90]
    idx_a = (jj << 6) - (ii + 1) * dx
    base_a = idx_a >> (6 - ua)
    shift_a = ((idx_a << ua) >> 1) & 31
    use_above = base_a >= -(1 << ua)
    ba = np.clip(base_a, -off_a, s << ua)
    idx_l = (ii << 6) - (jj + 1) * dy
    base_l = idx_l >> (6 - ul)
    shift_l = ((idx_l << ul) >> 1) & 31
    bl = np.clip(base_l, -off_l, (2 * s - 1) << ul)
    return (
        "mix",
        (
            np.clip(off_a + ba, 0, La - 1).astype(np.int32),
            np.clip(off_a + ba + 1, 0, La - 1).astype(np.int32),
            shift_a.astype(np.int32),
        ),
        (
            np.clip(off_l + bl, 0, Ll - 1).astype(np.int32),
            np.clip(off_l + bl + 1, 0, Ll - 1).astype(np.int32),
            shift_l.astype(np.int32),
        ),
        use_above,
        None,
    )


# --- device/analysis.py:336-378, device/pallas_kernels.py:113-123 ----------


@functools.lru_cache(None)
def hadamard8_f32():
    """The 8-point Sylvester Hadamard matrix, (8, 8) float32."""
    h = np.array([[1.0]], dtype=np.float32)
    while h.shape[0] < 8:
        h = np.block([[h, h], [h, -h]])
    return h.astype(np.float32)


@functools.lru_cache(None)
def dct_basis(s: int):
    """Calibrated forward DCT basis for size s (from ops/transforms) plus
    the tx->pixel SSE gain and the tx size's log_tx_scale."""
    from rav1e_tpu_torch.ops.transforms import _fwd_matrices
    from rav1e_tpu_torch.tx import TxSize, TxType, get_log_tx_scale

    tx_size = TxSize[f"TX_{s}X{s}"]
    fv, fh = _fwd_matrices(tx_size, TxType.DCT_DCT)
    gain2 = float((fv[0] ** 2).sum()) * float((fh[0] ** 2).sum())
    return (fv.astype(np.float32), fh.astype(np.float32), gain2,
            get_log_tx_scale(tx_size))


# --- tensors on a device -----------------------------------------------------


@dataclass(frozen=True)
class Tables:
    """The port's constant tensors on one device."""

    device: torch.device
    hadamard8: torch.Tensor  # (8, 8) f32
    mode_bits: torch.Tensor  # (13,) f32
    sm_weights: dict  # s -> (s,) int32 smooth-predictor weights
    dct: dict  # s -> (fv (s, s) f32, fh (s, s) f32, gain2, log_tx_scale)
    cdef_partial: torch.Tensor  # (64, 8*15) f64 direction partial-sum map
    cdef_uv_dir_422: torch.Tensor  # (8,) int64


def from_reference(device) -> Tables:
    """Build the port's constant tensors on ``device`` from the reference's
    JAX-free numpy sources."""
    device = torch.device(device)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    sizes = [1 << sl for sl in SIZE_LOG2S]
    dct = {}
    for s in sizes:
        fv, fh, gain2, lts = dct_basis(s)
        dct[s] = (t(fv, torch.float32), t(fh, torch.float32), gain2, lts)
    mats = _partial_matrices()  # (8, 64, 15) one-hot
    return Tables(
        device=device,
        hadamard8=t(hadamard8_f32(), torch.float32),
        mode_bits=t(MODE_BITS, torch.float32),
        sm_weights={s: t(SM_WEIGHTS[s], torch.int32) for s in sizes},
        dct=dct,
        cdef_partial=t(mats.transpose(1, 0, 2).reshape(64, 8 * 15),
                       torch.float64),
        cdef_uv_dir_422=t(CDEF_UV_DIR_422, torch.int64),
    )


@functools.lru_cache(None)
def on(device) -> Tables:
    """The cached :func:`from_reference` tables of one device."""
    return from_reference(device)
