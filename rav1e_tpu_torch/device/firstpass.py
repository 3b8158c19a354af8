"""The first pass over each input frame on the card: scene detection's and
the temporal-RDO lookahead's work over the frame's luma, which goes to the
card once, at intake.

The kernels (``csrc/firstpass.cu``), each with its wrapper and its plain
PyTorch version here:

- :func:`downsample`: the scene detector's 2x2 downsample,
  ``(a + b + c + d) >> 2`` (``api/context.py`` ``_downsample_luma``);
- :func:`scene_sums`: the integer sums behind its decisions: the gradient
  sums of Standard mode and the SAD sums of every global shift against the
  previous downsampled plane and the one before (``shifted_mad``);
- :func:`la_intra`: the lookahead's per-8x8 intra costs
  (``encoder/lookahead.py`` ``estimate_intra_costs``);
- :func:`la_motion`: its 16x16 diamond motion search with the per-8x8
  inter costs fused in (``lookahead_motion`` unseeded, then
  ``inter_costs_8x8``).

They replace no TPU kernel: the JAX package runs this work on the host, in
NumPy and C++.  Every result equals the host's exactly, so the keyframes,
the importances and the packets do not change.  A CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises; each launch
counts in ``kernels.LAUNCHES``.

:class:`FirstPass` is a context's first pass (:func:`for_context`): the
upload, a stream of the context's own at high priority (so nothing the
pipeline has queued, such as a predispatched chain, runs ahead of it), the
downloads through pinned memory behind a wait on that stream, and each
unplanned frame's luma on the card.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
import weakref

import numpy as np
import torch

from rav1e_tpu_torch.device import _build
from rav1e_tpu_torch.device.kernels import _count, _require_cuda
from rav1e_tpu_torch.utils.trace import span

IMP_BLOCK = 8  # lookahead cost cells
ME_BLOCK = 16  # lookahead motion blocks
_DIRS = ((-1, 0), (1, 0), (0, -1), (0, 1))


def shift_radius(h: int, w: int) -> int:
    """The scene detector's global-shift radius on an (h, w) downsampled
    plane: 3, or 0 on a plane 8 or fewer samples a side."""
    return 3 if (h > 8 and w > 8) else 0


def shifts(r: int):
    """The (dy, dx) shifts of radius ``r`` in :func:`scene_sums`' order."""
    return [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)]


def _luma_args(name: str, *planes) -> int:
    """Raise unless the planes are contiguous (h, w) planes of one shape and
    one sample type on one device; return the bytes a sample."""
    p0 = planes[0]
    for p in planes:
        if p.device != p0.device:
            raise ValueError(f"{name}: planes on {p.device} and {p0.device}")
        if p.dtype != p0.dtype or p.dtype not in (torch.uint8, torch.int16):
            raise TypeError(f"{name}: expects uint8 or int16 planes of one "
                            f"type, got {p.dtype}")
        if p.dim() != 2 or p.shape != p0.shape or not p.is_contiguous():
            raise ValueError(f"{name}: expects contiguous planes of one "
                             f"(h, w) shape, got {tuple(p.shape)}")
    return p0.element_size()


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _mark() -> None:
    """The ``firstpass_card`` counter: one a scene detection or lookahead
    group that ran the first pass's kernels."""
    with span("firstpass_card"):
        pass


# ---------------------------------------------------------------------------
# Scene detection
# ---------------------------------------------------------------------------


def downsample_plain(y: torch.Tensor) -> torch.Tensor:
    """(h, w) samples -> (h // 2, w // 2) int16 2x2 means truncated, the
    float mean truncated to uint16 of ``_downsample_luma`` (the plane itself
    when a side is 1)."""
    h2, w2 = (y.shape[0] // 2) * 2, (y.shape[1] // 2) * 2
    if h2 == 0 or w2 == 0:
        return y.to(torch.int16)
    q = y[:h2, :w2].to(torch.int32).reshape(h2 // 2, 2, w2 // 2, 2)
    return (q.sum(dim=(1, 3)) >> 2).to(torch.int16)


def downsample(y: torch.Tensor) -> torch.Tensor:
    """The scene detector's downsampled plane of an (h, w) uint8 or int16
    luma plane, as :func:`downsample_plain` computes it."""
    if y.device.type == "cpu":
        return downsample_plain(y)
    _require_cuda("fp_downsample", y.device)
    bpp = _luma_args("fp_downsample", y)
    h, w = y.shape
    shape = (h // 2, w // 2) if h >= 2 and w >= 2 else (h, w)
    out = torch.empty(shape, dtype=torch.int16, device=y.device)
    with torch.cuda.device(y.device):
        code = _build.lib().r1t_fp_downsample(
            y.data_ptr(), out.data_ptr(), h, w, bpp, y.device.index,
            _stream(y.device))
    _build.check(code, "fp_downsample")
    _count("fp_downsample")
    return out


def scene_sums_plain(cur, prev, prev2, r: int, grads: bool) -> torch.Tensor:
    """(2 + 2 (2r+1)^2,) int64: the sums of |dx| and |dy| over ``cur``
    (zero unless ``grads``), then for each shift of :func:`shifts` the sum
    of |cur - prev| over the overlap that ``shifted_mad`` slices, then the
    same against ``prev2`` (zero when it is None)."""
    ns = (2 * r + 1) ** 2
    out = torch.zeros(2 + 2 * ns, dtype=torch.int64, device=cur.device)
    c = cur.to(torch.int64)
    h, w = c.shape
    if grads:
        out[0] = (c[:, 1:] - c[:, :-1]).abs().sum()
        out[1] = (c[1:] - c[:-1]).abs().sum()
    for k, p in enumerate((prev, prev2)):
        if p is None:
            continue
        p = p.to(torch.int64)
        for i, (dy, dx) in enumerate(shifts(r)):
            a = c[max(dy, 0): h + min(dy, 0), max(dx, 0): w + min(dx, 0)]
            b = p[max(-dy, 0): h + min(-dy, 0), max(-dx, 0): w + min(-dx, 0)]
            out[2 + k * ns + i] = (a - b).abs().sum()
    return out


def scene_sums(cur, prev, prev2, r: int, grads: bool) -> torch.Tensor:
    """:func:`scene_sums_plain`'s sums of int16 downsampled planes (``prev2``
    may be None), on the planes' device."""
    if cur.device.type == "cpu":
        return scene_sums_plain(cur, prev, prev2, r, grads)
    _require_cuda("fp_scene_sums", cur.device)
    planes = (cur, prev) if prev2 is None else (cur, prev, prev2)
    _luma_args("fp_scene_sums", *planes)
    if cur.dtype != torch.int16:
        raise TypeError("fp_scene_sums: expects int16 downsampled planes")
    if r not in (0, 3):
        raise ValueError(f"fp_scene_sums: radius 0 or 3, got {r}")
    h, w = cur.shape
    ns = (2 * r + 1) ** 2
    out = torch.empty(2 + 2 * ns, dtype=torch.int64, device=cur.device)
    with torch.cuda.device(cur.device):
        code = _build.lib().r1t_fp_scene_sums(
            cur.data_ptr(), prev.data_ptr(),
            None if prev2 is None else prev2.data_ptr(), out.data_ptr(),
            h, w, r, int(grads), cur.device.index, _stream(cur.device))
    _build.check(code, "fp_scene_sums")
    _count("fp_scene_sums")
    return out


@functools.lru_cache(maxsize=8)
def _shift_counts(h: int, w: int, r: int) -> np.ndarray:
    return np.array([(h - abs(dy)) * (w - abs(dx)) for dy, dx in shifts(r)],
                    dtype=np.float64)


def scene_values(sums, h: int, w: int, r: int):
    """(gx, gy, the least mean |difference| over the shifts against the
    previous plane, the same against the one before) from
    :func:`scene_sums`' int64 sums of (h, w) planes: each mean is the sum
    over its count, which equals the host's float64 mean exactly (its
    integer sum is exact in float64), and ``np.diff``'s empty mean is NaN."""
    s = np.asarray(sums, dtype=np.int64)
    ns = (2 * r + 1) ** 2
    nx, ny = h * (w - 1), (h - 1) * w
    gx = int(s[0]) / nx if nx else float("nan")
    gy = int(s[1]) / ny if ny else float("nan")
    n = _shift_counts(h, w, r)
    mad = float((s[2: 2 + ns] / n).min())
    mad2 = float((s[2 + ns: 2 + 2 * ns] / n).min())
    return gx, gy, mad, mad2


# ---------------------------------------------------------------------------
# Lookahead
# ---------------------------------------------------------------------------


def la_intra_plain(y: torch.Tensor, bit_depth: int) -> torch.Tensor:
    """(h, w) samples -> (h // 8, w // 8) float64 intra costs, equal to
    ``estimate_intra_costs``: the least residual of the DC, row-mean and
    column-mean predictors, in integers scaled by 64, 8 and 8."""
    h, w = y.shape
    nby, nbx = h // IMP_BLOCK, w // IMP_BLOCK
    if nby == 0 or nbx == 0:
        return torch.ones((max(nby, 1), max(nbx, 1)), dtype=torch.float64,
                          device=y.device)
    c = y[: nby * 8, : nbx * 8].to(torch.int64).reshape(nby, 8, nbx, 8)
    total = c.sum(dim=(1, 3), keepdim=True)
    rows = c.sum(dim=3, keepdim=True)
    cols = c.sum(dim=1, keepdim=True)
    sdc = (64 * c - total).abs().sum(dim=(1, 3)).to(torch.float64) / 64.0
    srow = (8 * c - rows).abs().sum(dim=(1, 3)).to(torch.float64) / 8.0
    scol = (8 * c - cols).abs().sum(dim=(1, 3)).to(torch.float64) / 8.0
    best = torch.minimum(sdc, torch.minimum(srow, scol))
    return torch.clamp_min(best / (1 << (bit_depth - 8)), 1.0)


def la_intra(y: torch.Tensor, bit_depth: int, out=None) -> torch.Tensor:
    """:func:`la_intra_plain`'s grid of a uint8 or int16 luma plane, written
    into ``out`` when given (a contiguous float64 grid on the card)."""
    if y.device.type == "cpu":
        res = la_intra_plain(y, bit_depth)
        return res if out is None else out.copy_(res)
    _require_cuda("fp_la_intra", y.device)
    bpp = _luma_args("fp_la_intra", y)
    h, w = y.shape
    nby, nbx = h // IMP_BLOCK, w // IMP_BLOCK
    if nby == 0 or nbx == 0:
        ones = la_intra_plain(y, bit_depth)
        return ones if out is None else out.copy_(ones)
    if out is None:
        out = torch.empty((nby, nbx), dtype=torch.float64, device=y.device)
    _check_out("fp_la_intra", out, (nby, nbx), torch.float64, y.device)
    with torch.cuda.device(y.device):
        code = _build.lib().r1t_fp_la_intra(
            y.data_ptr(), out.data_ptr(), h, w, bpp, bit_depth,
            y.device.index, _stream(y.device))
    _build.check(code, "fp_la_intra")
    _count("fp_la_intra")
    return out


def _check_out(name, t, shape, dtype, dev) -> None:
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype
            or t.device != dev or not t.is_contiguous()):
        raise ValueError(f"{name}: output must be a contiguous {dtype} "
                         f"{tuple(shape)} on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def motion_shapes(h: int, w: int):
    """((mby, mbx) of the 16x16 motion grid, (nby, nbx) of the 8x8 inter
    cost grid) of an (h, w) plane."""
    return ((max(h // ME_BLOCK, 1), max(w // ME_BLOCK, 1)),
            (max(h // IMP_BLOCK, 1), max(w // IMP_BLOCK, 1)))


def _gather(plane, ys, xs, bh: int, bw: int):
    """(n,) top-left corners -> (n, bh, bw) blocks of ``plane``."""
    ar_h = torch.arange(bh, device=plane.device)
    ar_w = torch.arange(bw, device=plane.device)
    return plane[ys[:, None, None] + ar_h[None, :, None],
                 xs[:, None, None] + ar_w[None, None, :]]


def la_motion_plain(src: torch.Tensor, ref: torch.Tensor, bit_depth: int,
                    stats=None):
    """(h, w) source and reference samples -> ((mby, mbx, 2) int32 full-pel
    MVs, (nby, nbx) float64 inter costs): ``lookahead_motion`` unseeded,
    then ``inter_costs_8x8`` of its MVs.  The diamond search runs for every
    block at once in lockstep: within a pass each direction is tried from
    the position just accepted (strict <, out-of-frame candidates
    rejected), and a block leaves a step's passes at its first pass without
    a gain, as it does alone.  ``stats``: a dict that gets the number of
    in-frame candidate SADs the search took (``"sads"``)."""
    h, w = src.shape
    (mby, mbx), (nby, nbx) = motion_shapes(h, w)
    dev = src.device
    s = src.to(torch.int32)
    rf = ref.to(torch.int32)
    bh, bw = min(ME_BLOCK, h), min(ME_BLOCK, w)
    py = (torch.arange(mby, device=dev) * ME_BLOCK)[:, None].expand(
        mby, mbx).reshape(-1)
    px = (torch.arange(mbx, device=dev) * ME_BLOCK)[None, :].expand(
        mby, mbx).reshape(-1)
    blocks = _gather(s, py, px, bh, bw)

    def sad(dy, dx):
        ry, rx = py + dy, px + dx
        ok = (ry >= 0) & (rx >= 0) & (ry + bh <= h) & (rx + bw <= w)
        win = _gather(rf, ry.clamp(0, h - bh), rx.clamp(0, w - bw), bh, bw)
        return (win - blocks).abs().sum(dim=(1, 2)), ok

    zero = torch.zeros_like(py)
    best, _ok = sad(zero, zero)
    my, mx = zero.clone(), zero.clone()
    sads = py.numel()
    for step in (8, 4, 2, 1):
        active = torch.ones_like(py, dtype=torch.bool)
        while bool(active.any()):
            improved = torch.zeros_like(active)
            for dy, dx in _DIRS:
                cy, cx = my + dy * step, mx + dx * step
                d, ok = sad(cy, cx)
                if stats is not None:
                    sads += int((active & ok).sum())
                take = active & ok & (d < best)
                best = torch.where(take, d, best)
                my = torch.where(take, cy, my)
                mx = torch.where(take, cx, mx)
                improved |= take
            active = improved
    mvs = torch.stack([my, mx], dim=-1).to(torch.int32).reshape(mby, mbx, 2)
    if stats is not None:
        stats["sads"] = sads

    # inter costs: each 8x8 cell takes its 16x16 parent's MV (the last row
    # and column of the motion grid serve the cells past it), the reference
    # position clamped into the frame
    bh8, bw8 = min(IMP_BLOCK, h), min(IMP_BLOCK, w)
    cy = torch.arange(nby, device=dev)
    cx = torch.arange(nbx, device=dev)
    mv = mvs.to(torch.int64)[(cy // 2).clamp(max=mby - 1)][
        :, (cx // 2).clamp(max=mbx - 1)]
    y8 = (cy * IMP_BLOCK)[:, None].expand(nby, nbx)
    x8 = (cx * IMP_BLOCK)[None, :].expand(nby, nbx)
    ry = (y8 + mv[..., 0]).clamp(0, h - bh8).reshape(-1)
    rx = (x8 + mv[..., 1]).clamp(0, w - bw8).reshape(-1)
    a = _gather(s, y8.reshape(-1), x8.reshape(-1), bh8, bw8)
    b = _gather(rf, ry, rx, bh8, bw8)
    sads = (a - b).abs().sum(dim=(1, 2)).to(torch.float64)
    inter = torch.clamp_min(sads / (1 << (bit_depth - 8)), 1.0)
    return mvs, inter.reshape(nby, nbx)


def la_motion(src, ref, bit_depth: int, mvs=None, inter=None):
    """:func:`la_motion_plain`'s (MVs, inter costs) of two uint8 or int16
    luma planes, written into ``mvs`` and ``inter`` when given (contiguous
    int32 and float64 grids on the card)."""
    if src.device.type == "cpu":
        res = la_motion_plain(src, ref, bit_depth)
        if mvs is None:
            return res
        return mvs.copy_(res[0]), inter.copy_(res[1])
    _require_cuda("fp_la_motion", src.device)
    bpp = _luma_args("fp_la_motion", src, ref)
    h, w = src.shape
    (mby, mbx), (nby, nbx) = motion_shapes(h, w)
    dev = src.device
    if mvs is None:
        mvs = torch.empty((mby, mbx, 2), dtype=torch.int32, device=dev)
    if inter is None:
        inter = torch.empty((nby, nbx), dtype=torch.float64, device=dev)
    _check_out("fp_la_motion", mvs, (mby, mbx, 2), torch.int32, dev)
    _check_out("fp_la_motion", inter, (nby, nbx), torch.float64, dev)
    with torch.cuda.device(dev):
        code = _build.lib().r1t_fp_la_motion(
            src.data_ptr(), ref.data_ptr(), mvs.data_ptr(), inter.data_ptr(),
            h, w, bpp, bit_depth, dev.index, _stream(dev))
    _build.check(code, "fp_la_motion")
    _count("fp_la_motion")
    return mvs, inter


# ---------------------------------------------------------------------------
# A context's first pass
# ---------------------------------------------------------------------------

# the first pass's streams of each card not held by a context: made by
# csrc/firstpass.cu, never taken from PyTorch's pool, and kept for the
# process (a context returns its stream when it is collected)
_FREE_STREAMS = {}
_streams_lock = threading.Lock()


def _take_stream(dev) -> torch.cuda.ExternalStream:
    with _streams_lock:
        free = _FREE_STREAMS.setdefault(dev.index, [])
        if free:
            return free.pop()
    ptr = ctypes.c_void_p()
    _build.check(_build.lib().r1t_fp_stream_create(ctypes.byref(ptr),
                                                   dev.index),
                 "fp_stream_create")
    return torch.cuda.ExternalStream(ptr.value, device=dev)


def _give_stream(dev, stream) -> None:
    with _streams_lock:
        _FREE_STREAMS.setdefault(dev.index, []).append(stream)


def for_context(config, reorder: bool):
    """The :class:`FirstPass` of a context on a CUDA card, or None: a
    context on the CPU runs the host functions, and one that detects no
    scenes and runs no lookahead has nothing to put on the card.  The
    lookahead runs only for reordered pyramid groups with temporal RDO."""
    from rav1e_tpu_torch.config import SceneDetectionSpeed

    dev = torch.device(config.device)
    if dev.type != "cuda":
        return None
    e = config.enc
    ss = e.speed_settings
    lookahead = bool(getattr(ss, "temporal_rdo", True)) and reorder
    if (ss.scene_detection_mode == SceneDetectionSpeed.NoDetection
            and not lookahead):
        return None
    return FirstPass(dev, e.width, e.height, e.bit_depth, lookahead)


class FirstPass:
    """A context's first pass on ``device``: each input luma goes up once
    (:meth:`upload`) and the scene detector (:meth:`scene`) and the
    lookahead (:meth:`lookahead`) read it there.

    On a card everything runs on a stream of the pass's own at the card's
    greatest priority, never the legacy default stream nor PyTorch's stream
    pool (whose high-priority streams the graph captures draw from).  A
    luma crosses through a pinned staging buffer (a pageable copy would
    wait for the device to drain); a scene detection is one call into
    ``csrc/firstpass.cu`` (the downsample, the sums and their copy into
    pinned memory) and a wait on the stream (the ``firstpass_wait`` span),
    which also frees the staging buffer.  ``keep_luma``: hold each frame's
    luma until the frame is planned (:meth:`release`), for the lookahead.
    On the CPU, for tests, the same steps run the plain versions."""

    def __init__(self, device, width: int, height: int, bit_depth: int,
                 keep_luma: bool):
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.width, self.height, self.bit_depth = width, height, bit_depth
        self.keep_luma = keep_luma
        self.dtype = torch.uint8 if bit_depth == 8 else torch.int16
        self._np_dtype = np.uint8 if bit_depth == 8 else np.int16
        self.ds_shape = ((height // 2, width // 2)
                         if height >= 2 and width >= 2 else (height, width))
        self.radius = shift_radius(*self.ds_shape)
        self.luma = {}  # input frameno -> its luma on the device
        self.stream = None
        if dev.type == "cuda":
            self.stream = _take_stream(dev)
            # the stream goes back to the free list with the pass
            weakref.finalize(self, _give_stream, dev, self.stream)
            self._lib = _build.lib()
            self._staging = torch.empty((height, width), dtype=self.dtype,
                                        pin_memory=True)
            self._staged = self._staging.numpy()
            self._inflight = False  # an upload may still read the staging
            self._spare = None  # the luma buffer, when none is kept
            ns = (2 * self.radius + 1) ** 2
            self._sums = torch.empty(2 + 2 * ns, dtype=torch.int64,
                                     device=dev)
            self._sums_host = torch.empty(2 + 2 * ns, dtype=torch.int64,
                                          pin_memory=True)
            self._host = {}  # (numel, dtype) -> pinned download buffer

    def _on_stream(self):
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def _sync(self) -> None:
        """Wait until the pass's stream has run all it was given."""
        with span("firstpass_wait"):
            _build.check(self._lib.r1t_fp_sync(self.stream.cuda_stream),
                         "fp_sync")
        self._inflight = False

    def upload(self, frameno: int, y: np.ndarray) -> torch.Tensor:
        """Put a visible (height, width) luma plane on the device; kept
        under ``frameno`` when the lookahead will read it."""
        if y.shape != (self.height, self.width):
            raise ValueError(f"first pass: a {self.height}x{self.width} "
                             f"luma plane, got {y.shape}")
        with span("firstpass_upload"):
            if self.stream is None:
                t = torch.from_numpy(
                    np.ascontiguousarray(y).astype(self._np_dtype))
            else:
                if self._inflight:
                    self._sync()
                np.copyto(self._staged, y.view(self._np_dtype), casting="no")
                t = self._spare
                if t is None:
                    with torch.cuda.stream(self.stream):
                        t = torch.empty((self.height, self.width),
                                        dtype=self.dtype, device=self.device)
                    if not self.keep_luma:
                        self._spare = t
                _build.check(self._lib.r1t_fp_upload(
                    self._staging.data_ptr(), t.data_ptr(),
                    t.numel() * t.element_size(), self.device.index,
                    self.stream.cuda_stream), "fp_upload")
                self._inflight = True
            if self.keep_luma:
                self.luma[frameno] = t
            return t

    def release(self, below: int) -> None:
        """Drop the lumas of the frames before ``below`` (planned)."""
        for no in [no for no in self.luma if no < below]:
            del self.luma[no]

    def scene(self, luma, prev=None, prev2=None, grads: bool = False):
        """(the downsampled plane of ``luma`` on the device, and with an
        earlier plane ``prev`` the int64 :func:`scene_sums` against it and
        ``prev2`` on the host, else None)."""
        _mark()
        if self.stream is None:
            cur = downsample_plain(luma)
            if prev is None:
                return cur, None
            return cur, scene_sums_plain(cur, prev, prev2, self.radius,
                                         grads).numpy()
        _luma_args("fp_scene", luma)
        for p in (prev, prev2):
            if p is not None and (p.dtype != torch.int16 or p.device
                                  != luma.device or p.shape != self.ds_shape
                                  or not p.is_contiguous()):
                raise ValueError("fp_scene: earlier planes must be this "
                                 "pass's downsampled planes")
        if luma.shape != (self.height, self.width):
            raise ValueError(f"fp_scene: a {self.height}x{self.width} luma "
                             f"plane, got {tuple(luma.shape)}")
        with torch.cuda.stream(self.stream):
            cur = torch.empty(self.ds_shape, dtype=torch.int16,
                              device=self.device)
        _build.check(self._lib.r1t_fp_scene(
            luma.data_ptr(), cur.data_ptr(),
            None if prev is None else prev.data_ptr(),
            None if prev2 is None else prev2.data_ptr(),
            self._sums.data_ptr(), self._sums_host.data_ptr(),
            self.height, self.width, luma.element_size(), self.radius,
            int(grads), self.device.index, self.stream.cuda_stream),
            "fp_scene")
        _count("fp_downsample")
        if prev is None:
            return cur, None
        _count("fp_scene_sums")
        self._sync()
        return cur, self._sums_host.numpy().copy()

    def scene_values(self, sums):
        return scene_values(sums, *self.ds_shape, self.radius)

    def _download(self, t: torch.Tensor) -> np.ndarray:
        """A copy of a device tensor on the host, once the pass's stream
        has computed it."""
        if self.stream is None:
            return t.numpy().copy()
        key = (t.numel(), t.dtype)
        host = self._host.get(key)
        if host is None:
            host = self._host[key] = torch.empty(t.numel(), dtype=t.dtype,
                                                 pin_memory=True)
        with torch.cuda.stream(self.stream):
            host.copy_(t.reshape(-1), non_blocking=True)
        self._sync()
        return host.numpy().copy()

    def lookahead(self, nos, pairs):
        """The lookahead grids of a group: the intra costs of each input
        frame in ``nos``, and for each (source, reference) input frame pair
        the MVs and inter costs, as ``{no: intra}`` and ``[(mvs,
        inter)]`` numpy arrays; the frames' lumas are those kept at upload.
        One download for the group."""
        _mark()
        h, w = self.height, self.width
        bd = self.bit_depth
        ni = (h // IMP_BLOCK, w // IMP_BLOCK)
        (mby, mbx), ne = motion_shapes(h, w)
        if 0 in ni:
            # estimate_intra_costs' grid of ones, which no kernel computes
            ones = np.ones((max(ni[0], 1), max(ni[1], 1)), dtype=np.float64)
            intra = {no: ones.copy() for no in nos}
            nos = []
        a_i = ni[0] * ni[1]
        a_e = ne[0] * ne[1]
        a_m = mby * mbx * 2
        f64 = len(nos) * a_i + len(pairs) * a_e
        nbytes = 8 * f64 + 4 * len(pairs) * a_m
        with self._on_stream():
            buf = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
            grids = buf[: 8 * f64].view(torch.float64)
            mv_all = buf[8 * f64:].view(torch.int32)
            for k, no in enumerate(nos):
                la_intra(self.luma[no], bd,
                         out=grids[k * a_i: (k + 1) * a_i].view(ni))
            base = len(nos) * a_i
            for k, (src, ref) in enumerate(pairs):
                la_motion(self.luma[src], self.luma[ref], bd,
                          mvs=mv_all[k * a_m: (k + 1) * a_m].view(
                              mby, mbx, 2),
                          inter=grids[base + k * a_e: base + (k + 1) * a_e]
                          .view(ne))
            host = self._download(buf)
        g = host[: 8 * f64].view(np.float64)
        m = host[8 * f64:].view(np.int32)
        if nos:
            intra = {no: g[k * a_i: (k + 1) * a_i].reshape(ni)
                     for k, no in enumerate(nos)}
        base = len(nos) * a_i
        motion = [(m[k * a_m: (k + 1) * a_m].reshape(mby, mbx, 2),
                   g[base + k * a_e: base + (k + 1) * a_e].reshape(ne))
                  for k in range(len(pairs))]
        return intra, motion
