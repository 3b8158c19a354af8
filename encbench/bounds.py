"""The least time the card could take for a kernel's work: the yardstick of
the ``*_roofline`` metrics.

Copied from chip_smoke.py (``HBM_BYTES_PER_S``, ``INT32_LANES_PER_SM``,
``int32_ops_per_s``, ``bound``, ``grid_search_bound``) and frozen here. The
kernels' arithmetic is integer, so the operations bound is the card's INT32
rate: SMs x 64 INT32 lanes x the maximum SM clock; the bytes bound is the
bytes each input is read once and each output written once over the HBM
rate of an H100 SXM.
"""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
INT32_LANES_PER_SM = 64


def int32_ops_per_s():
    """(32-bit integer operations per second of card 0, its SM count, its
    maximum SM clock in MHz)."""
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    mhz = float(out.stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_LANES_PER_SM * mhz * 1e6, sms, mhz


def bound_s(nbytes: float, ops: float, ops_per_s: float) -> float:
    """Least seconds: the larger of bytes over the HBM rate and operations
    over ``ops_per_s``."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)


def grid_search_work(n: int, n_seeds: int, R: int, blk: int):
    """(bytes, operations) of one grid_search round over ``n`` blocks.

    Operations: 3 per sample (difference, absolute value, add) for every
    block, seed and candidate of the (2R+1)^2 grid, as chip_smoke.py counts
    them. Bytes: the int32 source blocks, block origins and seeds read once
    and the MVs written once; the reference samples the windows cover depend
    on the seeds and are left out, so the bytes are a lower bound (the
    operations bound these rounds)."""
    nbytes = 4 * (n * blk * blk + 2 * n + n_seeds * 2 * n + 2 * n)
    ops = 3 * n * n_seeds * (2 * R + 1) ** 2 * blk * blk
    return nbytes, ops
