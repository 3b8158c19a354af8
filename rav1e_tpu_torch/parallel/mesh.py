"""Multi-device sharding: the device analysis over a 1-D mesh of devices.

Counterpart of ``rav1e_tpu/parallel/mesh.py``.  Row bands of a frame shard
across devices, each device running the whole frame-analysis program
(:mod:`rav1e_tpu_torch.device.analysis`) on its band.  One process drives
every device, as the reference's single controller does: a :class:`Mesh` is
an axis name and one ``torch.device`` per slot, and each slot runs on its
device inside ``torch.cuda.device(d)`` on a CUDA stream of its own.  The
reference's two collectives are written out:

- ``ppermute``, the halo exchange: a neighbour's edge rows are copied to the
  band's device on the receiving stream, behind an event recorded on the
  sending one (:func:`recv`);
- ``psum``: the band results are gathered onto the first device
  (:func:`send_back`) and summed there.

Several slots may name one device: four slots of ``cuda:0`` run four bands
on four streams of one card.  A mesh of CPU slots (``devices=["cpu"] * n``)
runs its bands one after the other; it stands where the reference's tests
use XLA's forced host devices.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass

import numpy as np
import torch


SB = 64  # superblock rows: every band is whole superblock rows

# The reach of the analysis in rows beyond a block, stage by stage
# (device/me.py, device/analysis.py, device/constants.py):
# - ME level 2 (quarter resolution, 16-row blocks = 64 full rows) reads the
#   reference up to PAD_L2 = 17 quarter rows beyond its block: 68 full rows;
# - ME level 1 (half resolution) up to PAD_L1 = 22 half rows: 44 full rows;
#   its seeds come from the co-located level-2 block, not from neighbours;
# - ME level 0 and the subpel window up to PAD_L0 = 46 rows;
# - the MC residual of the cost fields reads up to |mv >> 3| <= 39 rows;
# - the intra edges of a 64x64 block (analysis._block_edges) read 2 * 64
#   rows down from its top, 64 rows beyond it, and one row above it;
# - the partition merge works inside aligned 64x64 superblocks.
# The widest is 68 rows.  Rounded up to whole superblock rows it is 128,
# which also keeps every band's pyramid on the frame's 64-row grid.
ANALYSIS_HALO = 128

# motion-search reach of the reference's band semantics: L0 clip +-38 px +
# the subpel window margin, rounded up to a whole superblock so band heights
# stay 64-multiples (rav1e_tpu/parallel/mesh.py:85)
ME_HALO = 64


class Mesh:
    """A 1-D device mesh: ``axis`` and one ``torch.device`` per slot.  The
    slots' CUDA streams are made at their first use, once: every GOP worker
    of a process shares the one cached mesh of ``analysis._analysis_mesh``,
    and a copy ordered on a stream nobody waits for would race."""

    def __init__(self, devices, axis: str = "tile"):
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis = axis
        self._streams = None
        self._lock = threading.Lock()

    @property
    def size(self) -> int:
        return len(self.devices)

    def streams(self):
        """One CUDA stream per slot, None for a CPU slot; the same tuple for
        every caller, whichever thread asks first."""
        if self._streams is None:
            with self._lock:
                if self._streams is None:
                    self._streams = tuple(
                        torch.cuda.Stream(device=d) if d.type == "cuda"
                        else None for d in self.devices)
        return self._streams


def make_mesh(n_devices: int = 0, axis: str = "tile", devices=None) -> Mesh:
    """A mesh of ``n_devices`` slots (0: all): the visible CUDA devices, or
    the ``devices`` given, which may be CPU slots or several slots of one
    card.  Raises when there are fewer devices than asked for; it never
    takes the CPU unless ``devices`` names it."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible (ask for "
                               "CPU slots with devices=['cpu'] * n)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [torch.device(d) for d in devices]
        for d in devices:
            if d.type == "cuda" and (not torch.cuda.is_available() or (
                    d.index or 0) >= torch.cuda.device_count()):
                raise RuntimeError(f"make_mesh: {d} is not visible")
            if d.type not in ("cuda", "cpu"):
                raise RuntimeError(f"make_mesh: no slot on {d}")
        # a bare "cuda" is the current card: slots are keyed by exact device
        devices = [torch.device("cuda", torch.cuda.current_device())
                   if d.type == "cuda" and d.index is None else d
                   for d in devices]
    if n_devices:
        if len(devices) < n_devices:
            raise RuntimeError(f"need {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(devices, axis)


@contextlib.contextmanager
def on_slot(mesh: Mesh, i: int):
    """Run the body on slot i: its device and its stream."""
    s = mesh.streams()[i]
    if s is None:
        yield
        return
    with torch.cuda.device(mesh.devices[i]), torch.cuda.stream(s):
        yield


def recv(t: torch.Tensor, mesh: Mesh, i: int) -> torch.Tensor:
    """``t``, made on its device's current stream, on slot i's device and
    ordered on slot i's stream (the receiving half of ppermute)."""
    d, s = mesh.devices[i], mesh.streams()[i]
    if s is None:
        return t.to(d)
    # the sender's event: what was queued for t on its device comes first
    s.wait_stream(torch.cuda.current_stream(t.device))
    with torch.cuda.device(d), torch.cuda.stream(s):
        if t.device == d:
            t.record_stream(s)
            return t
        # across cards the copy runs on the sender's current stream, and
        # the receiving stream waits for it (PyTorch's device-to-device copy)
        return t.to(d, non_blocking=True)


def send_back(t: torch.Tensor, mesh: Mesh, i: int, dst) -> torch.Tensor:
    """A result of slot i on ``dst``, ordered on dst's current stream (the
    gathering half of psum)."""
    s = mesh.streams()[i]
    if s is None:
        return t.to(dst)
    if t.device == dst:
        cur = torch.cuda.current_stream(dst)
        cur.wait_stream(s)
        t.record_stream(cur)
        return t
    with torch.cuda.device(t.device), torch.cuda.stream(s):
        return t.to(dst, non_blocking=True)


def band_rows(h: int, n: int):
    """(lo, hi) rows of n bands of whole superblock rows over h rows, the
    first bands one superblock row taller where they do not split evenly
    (1088 rows over 4 slots: 320/256/256/256).  None when there are fewer
    superblock rows than slots or fewer than 2 slots: such a frame is
    analysed whole on the first slot (the reference's replication)."""
    sb = h // SB
    if n < 2 or sb < n:
        return None
    q, r = divmod(sb, n)
    out, lo = [], 0
    for i in range(n):
        hi = lo + SB * (q + (i < r))
        out.append((lo, hi))
        lo = hi
    return tuple(out)


@dataclass
class ShardedPlane:
    """An (H, W) plane split by rows over a mesh: ``bands[i]`` holds rows
    ``rows[i][0]:rows[i][1]`` on ``mesh.devices[i]``."""

    mesh: Mesh
    rows: tuple
    bands: tuple

    @property
    def shape(self):
        return (self.rows[-1][1], self.bands[0].shape[1])

    @classmethod
    def put(cls, mesh: Mesh, rows, plane: np.ndarray) -> "ShardedPlane":
        """Split a host plane over the mesh's slots: each band crosses to
        its own device once."""
        return cls(mesh, tuple(rows), tuple(
            torch.from_numpy(np.ascontiguousarray(plane[lo:hi])).to(d)
            for (lo, hi), d in zip(rows, mesh.devices)))

    def window(self, i: int, r0: int, r1: int) -> torch.Tensor:
        """Rows r0:r1 of the plane on slot i: its own rows and the halo rows
        of the bands that hold them, received on slot i's stream."""
        parts = []
        for (lo, hi), band in zip(self.rows, self.bands):
            a, z = max(lo, r0), min(hi, r1)
            if a < z:
                parts.append(recv(band[a - lo : z - lo], self.mesh, i))
        if len(parts) == 1:
            return parts[0]
        with on_slot(self.mesh, i):
            return torch.cat(parts)


def _even_rows(mesh: Mesh, h: int):
    n = mesh.size
    if h % (n * SB):
        raise ValueError(f"height {h} must split over the mesh's {n} slots "
                         "in superblock rows")
    band_h = h // n
    return tuple((i * band_h, (i + 1) * band_h) for i in range(n))


def sharded_frame_analysis(mesh: Mesh, luma, qindex: int, lam: float,
                           bd: int = 8):
    """Band-sharded intra frame analysis + the rate-estimate psum.

    ``luma``: (H, W) numpy array, H divisible by 64 * n_slots (each band is
    whole superblock rows, standing in for a tile row, analysed alone: no
    halo, no inter).  Returns (size_log2, mode, use_inter, bits_total) with
    the per-8px-cell maps assembled across bands and bits_total the sum of
    the bands' estimates."""
    from rav1e_tpu_torch.device.analysis import _frame_analysis, _scalars

    h, w = luma.shape
    rows = _even_rows(mesh, h)
    plane = ShardedPlane.put(mesh, rows, np.asarray(luma, np.int32))
    dev0 = mesh.devices[0]
    outs = []
    for i, (lo, hi) in enumerate(rows):
        band = plane.window(i, lo, hi)
        with on_slot(mesh, i):
            q, lam_t = _scalars(qindex, lam, bd, mesh.devices[i])
            size_map, mode_map, inter_map, bits, *_ = _frame_analysis(
                band, band, band, band, q, lam_t, bd, has_inter=False)
        outs.append([send_back(t, mesh, i, dev0)
                     for t in (size_map, mode_map, inter_map, bits)])
    maps = [torch.cat([o[k] for o in outs]).cpu().numpy() for k in range(3)]
    # psum: the gathered band values summed on the first device
    return (*maps, float(torch.stack([o[3] for o in outs]).sum()))


def sharded_inter_analysis(mesh: Mesh, luma, ref, qindex: int, lam: float,
                           bd: int = 8):
    """Band-sharded INTER frame analysis with a halo exchange.

    Motion estimation reads reference pixels beyond a block, so each band
    takes ``ME_HALO`` rows of source and reference from each neighbour (the
    reference's two nearest-neighbour ppermutes) and replicates its own edge
    row on a side that is the frame's edge.  Every slot runs the full inter
    analysis (ME pyramid + subpel + intra/inter cost fields + partition
    merge) on its extended band and keeps the interior decisions; the frame
    rate estimate is the psum of the interior rate maps.

    Returns (size_log2, mode, use_inter, mv0 (H/16, W/16, 2), bits_total).
    """
    from rav1e_tpu_torch.device.analysis import _frame_analysis, _scalars

    n = mesh.size
    h, w = luma.shape
    rows = _even_rows(mesh, h)
    planes = [ShardedPlane.put(mesh, rows, np.asarray(p, np.int32))
              for p in (luma, ref)]
    Hh = ME_HALO
    dev0 = mesh.devices[0]
    outs = []
    for i, (lo, hi) in enumerate(rows):
        ext = []
        for p in planes:
            top = p.window(i, lo - Hh, lo) if i > 0 else None
            own = p.window(i, lo, hi)
            bot = p.window(i, hi, hi + Hh) if i < n - 1 else None
            with on_slot(mesh, i):
                if top is None:
                    top = own[:1].expand(Hh, w)
                if bot is None:
                    bot = own[-1:].expand(Hh, w)
                ext.append(torch.cat([top, own, bot]))
        bs, br = ext
        with on_slot(mesh, i):
            q, lam_t = _scalars(qindex, lam, bd, mesh.devices[i])
            size_map, mode_map, inter_map, _b, mv0, _m1, _m2, rate_map = \
                _frame_analysis(bs, br, br, br, q, lam_t, bd, has_inter=True)
            c, nc = Hh // 8, (hi - lo) // 8
            m, nm = Hh // 16, (hi - lo) // 16
            band_out = (size_map[c : c + nc], mode_map[c : c + nc],
                        inter_map[c : c + nc], mv0[m : m + nm],
                        rate_map[c : c + nc].sum())
        outs.append([send_back(t, mesh, i, dev0) for t in band_out])
    maps = [torch.cat([o[k] for o in outs]).cpu().numpy() for k in range(4)]
    return (*maps, float(torch.stack([o[4] for o in outs]).sum()))
