"""The two hand-written kernels of the analysis, their wrappers and their
plain PyTorch versions, and the launch counts of every kernel of the port.

Counterpart of ``rav1e_tpu/device/pallas_kernels.py``:

- :func:`satd8`: Hadamard SATD summed over the 8x8 cells of s x s blocks
  (``csrc/satd8.cu``; TPU kernel ``_satd_kernel``);
- :func:`grid_search`: one whole full-pel round of the motion search, the
  window gather, the SADs over a step-spaced candidate grid and the
  tie-broken argmin (``csrc/grid_search.cu``; TPU kernel
  ``_sad_kernel_factory`` as ``rav1e_tpu/device/me.py`` ``_grid_search``
  uses it).  :func:`sad_grid_plain` is the counterpart of the TPU kernel
  alone.

The filter stage's kernels have their wrappers beside their plain versions:
``cdef_dirs``, ``cdef_search`` and ``cdef_apply`` (``csrc/cdef.cu``) in
``device/filters.py``, ``deblock_edges`` (``csrc/deblock.cu``) as
``device/dsp.py`` ``deblock_pass_device``; the first pass's kernels
(``csrc/firstpass.cu``: ``fp_downsample``, ``fp_scene_sums``,
``fp_la_intra``, ``fp_la_motion``) in ``device/firstpass.py``.

A wrapper dispatches on the device of the tensor it is given: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel or raises.  A
launch goes to the tensors' own card, on that card's current stream (a
mesh slot's stream, under :mod:`rav1e_tpu_torch.parallel`), and the
wrappers refuse tensors on different devices.  Each wrapper adds one to its
count in :data:`LAUNCHES` where it launches its kernel, and nowhere else.
Inside a CUDA graph capture (:func:`counting_capture`) a launch is recorded
into the graph, not run: it goes to the capture's tally, and each replay of
the graph adds that tally to :data:`LAUNCHES` (:func:`add_launches`).
"""

from __future__ import annotations

import contextlib
import threading

import torch

from rav1e_tpu_torch.device import _build
from rav1e_tpu_torch.device.constants import ME_BLOCK, device_cache, on as _tables

# kernel launches since the last reset_launches(), counted under a lock:
# GOP-parallel workers launch from several threads
LAUNCHES = {"satd8": 0, "grid_search": 0, "cdef_dirs": 0, "cdef_search": 0,
            "cdef_apply": 0, "deblock_edges": 0, "fp_downsample": 0,
            "fp_scene_sums": 0, "fp_la_intra": 0, "fp_la_motion": 0}
_launch_lock = threading.Lock()

SATD_SIZES = (8, 16, 32, 64)  # block sides csrc/satd8.cu takes


def reset_launches() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


# the tally of the capture this thread runs, if any
_capturing = threading.local()


def _count(name: str) -> None:
    tally = getattr(_capturing, "tally", None)
    if tally is not None:
        tally[name] += 1
        return
    with _launch_lock:
        LAUNCHES[name] += 1


@contextlib.contextmanager
def counting_capture():
    """Inside, this thread's kernel launches go into the yielded tally (name
    -> launches) instead of :data:`LAUNCHES`: a graph capture records them,
    and its replays run them (``device/graphs.py``)."""
    tally = dict.fromkeys(LAUNCHES, 0)
    outer = getattr(_capturing, "tally", None)
    _capturing.tally = tally
    try:
        yield tally
    finally:
        _capturing.tally = outer


def add_launches(tally: dict) -> None:
    """Count the launches a graph replay ran."""
    with _launch_lock:
        for name, n in tally.items():
            LAUNCHES[name] += n


def _check_tensors(name: str, *tensors) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expects int32 tensors, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous tensors")


def _require_cuda(name: str, dev) -> None:
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


def check_satd8_inputs(diff: torch.Tensor) -> None:
    """Raise unless ``diff`` is what csrc/satd8.cu reads, on any device."""
    _check_tensors("satd8", diff)
    *_lead, sh, sw = diff.shape
    if sh != sw or sh not in SATD_SIZES:
        raise ValueError(f"satd8: block side must be one of {SATD_SIZES}, "
                         f"got {sh}x{sw}")
    if diff.data_ptr() % 16:
        raise ValueError("satd8: diff must be 16-byte aligned")


def satd8(diff: torch.Tensor) -> torch.Tensor:
    """(..., s, s) int32 diffs -> (...) f32 SATD summed over the 8x8
    Hadamard cells (ops/dist get_satd normalisation)."""
    if diff.device.type == "cpu":
        return satd8_plain(diff)
    _require_cuda("satd8", diff.device)
    check_satd8_inputs(diff)
    *lead, sh, _sw = diff.shape
    out = torch.empty(lead, dtype=torch.float32, device=diff.device)
    n = out.numel()
    if n == 0:
        return out
    with torch.cuda.device(diff.device):
        code = _build.lib().r1t_satd8(
            diff.data_ptr(), out.data_ptr(), n, sh, diff.device.index,
            torch.cuda.current_stream(diff.device).cuda_stream,
        )
    _build.check(code, "satd8")
    _count("satd8")
    return out


# ---------------------------------------------------------------------------
# Full-pel candidate-grid round
# ---------------------------------------------------------------------------

_I32 = torch.int32


def sad_grid_plain(src_blocks: torch.Tensor, win: torch.Tensor, blk: int,
                   R: int, step: int) -> torch.Tensor:
    """(n, blk, blk) source blocks x (n, W, W) windows, W = blk + 2*R*step
    -> (n, (2R+1)^2) int32 SADs over the step-spaced candidate grid: the
    slice-and-sum of ``rav1e_tpu/device/me.py:115-123``, the function of
    the TPU kernel ``_sad_kernel_factory``."""
    cols = [
        (win[:, oy * step : oy * step + blk, ox * step : ox * step + blk]
         - src_blocks).abs().sum(dim=(1, 2), dtype=torch.int32)
        for oy in range(2 * R + 1) for ox in range(2 * R + 1)
    ]
    return torch.stack(cols, dim=1)


def gather_windows(ref_pad, ty, tx, W):
    """(n,) top-left coords -> (n, W, W) windows, by advanced indexing."""
    ar = torch.arange(W, dtype=_I32, device=ref_pad.device)
    wy = ty[:, None, None] + ar[None, :, None]
    wx = tx[:, None, None] + ar[None, None, :]
    return ref_pad[wy, wx]


@device_cache
def _grid_tie(R: int, device):
    side = 2 * R + 1
    return torch.tensor(
        [abs(oy - R) + abs(ox - R) for oy in range(side) for ox in range(side)],
        dtype=_I32, device=device,
    )


def grid_search_plain(src_blocks, ref_pad, base_y, base_x, seeds, blk, R,
                      step, pad_off, clip_mv):
    """One full-pel candidate-grid round for every block at once: the body of
    ``rav1e_tpu/device/me.py`` ``_grid_search`` on :func:`sad_grid_plain`.

    src_blocks: (n, blk, blk) int32; seeds: sequence of (n, 2) int32 px
    seeds (each clipped to +-clip_mv); evaluates the (2R+1)^2 grid at `step`
    px spacing around every seed and picks the global best per block.  SADs
    are scaled by 64 and offset by the L1 norm of the grid offset and the
    seed index, so ties prefer the earlier seed and the candidate nearest
    it.  Returns the updated (n, 2) int32 MVs.
    """
    side = 2 * R + 1
    ncand = side * side
    W = blk + 2 * R * step
    tie = _grid_tie(R, src_blocks.device)
    sads = []
    origins = []
    for si, seed in enumerate(seeds):
        sy = seed[:, 0].clamp(-clip_mv, clip_mv)
        sx = seed[:, 1].clamp(-clip_mv, clip_mv)
        ty = base_y + sy - R * step + pad_off
        tx = base_x + sx - R * step + pad_off
        win = gather_windows(ref_pad, ty, tx, W)
        origins.append((sy, sx))
        d = sad_grid_plain(src_blocks, win, blk, R, step)
        sads.append(d * 64 + tie[None, :] + si)
    S = torch.cat(sads, dim=1)  # (n, nseeds * ncand)
    k = torch.argmin(S, dim=1).to(_I32)
    kk = k % ncand
    oy = kk // side - R
    ox = kk % side - R
    si = (k // ncand).long()[:, None]
    sy = torch.stack([o[0] for o in origins], dim=1)  # (n, nseeds)
    sx = torch.stack([o[1] for o in origins], dim=1)
    by = torch.gather(sy, 1, si)[:, 0]
    bx = torch.gather(sx, 1, si)[:, 0]
    return torch.stack([by + step * oy, bx + step * ox], dim=-1)


def grid_search(src_blocks, ref_pad, base_y, base_x, seeds, blk: int, R: int,
                step: int, pad_off: int, clip_mv: int) -> torch.Tensor:
    """One full-pel round of me._grid_search: (n, 16, 16) int32 source blocks,
    the (Hp, Wp) int32 edge-padded reference plane, (n,) int32 block origins
    and 1 or 2 (n, 2) int32 seeds (a list, or an (nseeds, n, 2) tensor) ->
    (n, 2) int32 MVs, as :func:`grid_search_plain` computes them.  Every
    window must lie inside ``ref_pad`` (the pyramid's padding sees to it)."""
    if src_blocks.device.type == "cpu":
        return grid_search_plain(src_blocks, ref_pad, base_y, base_x, seeds,
                                 blk, R, step, pad_off, clip_mv)
    seeds = list(seeds)
    _require_cuda("grid_search", src_blocks.device)
    check_grid_search_inputs(src_blocks, ref_pad, base_y, base_x, seeds, blk,
                             R, step, clip_mv)
    n = src_blocks.shape[0]
    out = torch.empty((n, 2), dtype=_I32, device=src_blocks.device)
    if n == 0:
        return out
    with torch.cuda.device(src_blocks.device):
        code = _build.lib().r1t_grid_search(
            src_blocks.data_ptr(), ref_pad.data_ptr(), base_y.data_ptr(),
            base_x.data_ptr(), seeds[0].data_ptr(), seeds[-1].data_ptr(),
            out.data_ptr(), n, ref_pad.shape[0], ref_pad.shape[1], len(seeds),
            R, step, pad_off, clip_mv, src_blocks.device.index,
            torch.cuda.current_stream(src_blocks.device).cuda_stream,
        )
    _build.check(code, "grid_search")
    _count("grid_search")
    return out


def check_grid_search_inputs(src_blocks, ref_pad, base_y, base_x, seeds,
                             blk: int, R: int, step: int,
                             clip_mv: int) -> None:
    """Raise unless the arguments are what csrc/grid_search.cu reads, on any
    device (``seeds`` a list)."""
    _check_tensors("grid_search", src_blocks, ref_pad, base_y, base_x, *seeds)
    n = src_blocks.shape[0]
    W = blk + 2 * R * step
    if blk != ME_BLOCK or tuple(src_blocks.shape) != (n, blk, blk):
        raise ValueError(f"grid_search: source blocks must be (n, {ME_BLOCK}, "
                         f"{ME_BLOCK}), got {tuple(src_blocks.shape)}")
    if not 1 <= len(seeds) <= 2:
        raise ValueError(f"grid_search: 1 or 2 seeds, got {len(seeds)}")
    for t, shape in ((base_y, (n,)), (base_x, (n,)),
                     *((sd, (n, 2)) for sd in seeds)):
        if tuple(t.shape) != shape:
            raise ValueError(f"grid_search: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
    if ref_pad.dim() != 2 or min(ref_pad.shape) < W:
        raise ValueError(f"grid_search: reference plane {tuple(ref_pad.shape)}"
                         f" is smaller than a {W}x{W} window")
    if R < 0 or step < 1 or clip_mv < 0:
        raise ValueError(f"grid_search: R={R} step={step} clip_mv={clip_mv}")
    if 8 * (blk * blk + len(seeds) * W * W) * 4 > 48 * 1024:
        raise ValueError("grid_search: 8 blocks and their windows exceed 48 KB"
                         " of shared memory")
    if src_blocks.data_ptr() % 16:
        raise ValueError("grid_search: source blocks must be 16-byte aligned")
