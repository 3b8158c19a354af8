"""The two hand-written kernels of the analysis, their wrappers and their
plain PyTorch versions.

Counterpart of ``rav1e_tpu/device/pallas_kernels.py``:

- :func:`satd8`: Hadamard SATD summed over the 8x8 cells of s x s blocks
  (``csrc/satd8.cu``; TPU kernel ``_satd_kernel``);
- :func:`sad_grid`: full-pel SAD over a step-spaced candidate grid
  (``csrc/sad_grid.cu``; TPU kernel ``_sad_kernel_factory``).

A wrapper dispatches on the device of the tensor it is given: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel or raises.  Each
wrapper adds one to its count in :data:`LAUNCHES` where it launches its
kernel, and nowhere else.
"""

from __future__ import annotations

import torch

from rav1e_tpu_torch.device import _build
from rav1e_tpu_torch.device.constants import on as _tables

# kernel launches since the last reset_launches()
LAUNCHES = {"satd8": 0, "sad_grid": 0}

SATD_SIZES = (8, 16, 32, 64)  # block sides csrc/satd8.cu takes


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _require_cuda(name: str, *tensors) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expects int32 tensors, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous tensors")
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")


# ---------------------------------------------------------------------------
# SATD
# ---------------------------------------------------------------------------


def satd8_plain(diff: torch.Tensor) -> torch.Tensor:
    """(..., s, s) int diffs -> (...) f32 SATD summed over the 8x8 Hadamard
    cells: the einsum of ``rav1e_tpu/device/analysis.py:357-364``."""
    *lead, sh, sw = diff.shape
    d = diff.to(torch.float32).reshape(*lead, sh // 8, 8, sw // 8, 8)
    d = d.movedim(-2, -3)  # (..., sh/8, sw/8, 8, 8)
    h8 = _tables(diff.device).hadamard8
    t = torch.matmul(torch.matmul(h8, d), h8)
    cells = t.abs().sum(dim=(-1, -2))
    cells = torch.floor((cells + 4.0) / 8.0)
    return cells.sum(dim=(-1, -2))


def satd8(diff: torch.Tensor) -> torch.Tensor:
    """(..., s, s) int32 diffs -> (...) f32 SATD summed over the 8x8
    Hadamard cells (ops/dist get_satd normalisation)."""
    if diff.device.type == "cpu":
        return satd8_plain(diff)
    _require_cuda("satd8", diff)
    *lead, sh, sw = diff.shape
    if sh != sw or sh not in SATD_SIZES:
        raise ValueError(f"satd8: block side must be one of {SATD_SIZES}, "
                         f"got {sh}x{sw}")
    if diff.data_ptr() % 16:
        raise ValueError("satd8: diff must be 16-byte aligned")
    out = torch.empty(lead, dtype=torch.float32, device=diff.device)
    n = out.numel()
    if n == 0:
        return out
    code = _build.lib().r1t_satd8(
        diff.data_ptr(), out.data_ptr(), n, sh, diff.device.index or 0,
        torch.cuda.current_stream(diff.device).cuda_stream,
    )
    _build.check(code, "satd8")
    LAUNCHES["satd8"] += 1
    return out


# ---------------------------------------------------------------------------
# SAD candidate grid
# ---------------------------------------------------------------------------


def sad_grid_plain(src_blocks: torch.Tensor, win: torch.Tensor, blk: int,
                   R: int, step: int) -> torch.Tensor:
    """The slice-and-sum of ``rav1e_tpu/device/me.py:115-123``."""
    cols = [
        (win[:, oy * step : oy * step + blk, ox * step : ox * step + blk]
         - src_blocks).abs().sum(dim=(1, 2), dtype=torch.int32)
        for oy in range(2 * R + 1) for ox in range(2 * R + 1)
    ]
    return torch.stack(cols, dim=1)


def sad_grid(src_blocks: torch.Tensor, win: torch.Tensor, blk: int, R: int,
             step: int) -> torch.Tensor:
    """(n, blk, blk) i32 source blocks x (n, W, W) i32 search windows,
    W = blk + 2*R*step -> (n, (2R+1)^2) i32 SADs over the step-spaced
    candidate grid (the inner loop of me._grid_search)."""
    if src_blocks.device.type == "cpu":
        return sad_grid_plain(src_blocks, win, blk, R, step)
    _require_cuda("sad_grid", src_blocks, win)
    n = src_blocks.shape[0]
    W = blk + 2 * R * step
    if tuple(src_blocks.shape) != (n, blk, blk) or tuple(win.shape) != (n, W, W):
        raise ValueError(
            f"sad_grid: shapes {tuple(src_blocks.shape)}, {tuple(win.shape)} "
            f"do not fit blk={blk} R={R} step={step}"
        )
    if (blk * blk + W * W) * 4 > 48 * 1024:
        raise ValueError("sad_grid: block and window exceed 48 KB of shared "
                         "memory")
    out = torch.empty((n, (2 * R + 1) ** 2), dtype=torch.int32,
                      device=src_blocks.device)
    if n == 0:
        return out
    code = _build.lib().r1t_sad_grid(
        src_blocks.data_ptr(), win.data_ptr(), out.data_ptr(), n, blk, R,
        step, src_blocks.device.index or 0,
        torch.cuda.current_stream(src_blocks.device).cuda_stream,
    )
    _build.check(code, "sad_grid")
    LAUNCHES["sad_grid"] += 1
    return out
