"""The device passes as replayed programs: CUDA graphs per key, the port's
counterparts of the reference's compiled programs.

- :class:`ChainPrograms`: the device chain, each of its five stages one
  graph per (geometry, CDEF candidate lists), for ``rav1e_tpu/device/
  chain.py`` ``chain_stages_jit``;
- :class:`AnalysisPrograms`: the whole-frame analysis, one graph per
  (padded shape, bit depth, references), for ``rav1e_tpu/device/
  analysis.py`` ``frame_analysis_jit``; the satd8 and grid_search kernels
  run inside it as captured nodes;
- :class:`CdefPrograms`: the standalone CDEF stage, one graph per (planes,
  grid, damping, bit depth, strength lists), for ``rav1e_tpu/device/
  filters.py`` ``cdef_stage_jit``.

Run eagerly, a bidirectional 1080p chain frame is some 14,500 PyTorch
launches and an analysis 2,300-9,100, and the host launching them, not the
card, sets the pace.  A runner keeps for every key static input buffers
into which each run copies its inputs.  The first run of a key runs the
key's calls eagerly; that also makes every device constant they read
(``constants.device_cache``) and launches every kernel they use, which a
capture cannot do.  The second run captures each call as a graph, on a side
stream, into the runner's memory pool, and from then on a run is a replay
per call on the pipeline's current stream.  A call's outputs stay in the
pool, where the next call's graph reads them.

What must outlive the next replay is copied out right after the replay, by
the runner or its caller: the chain's padded reconstruction and levels
buffer (``chain.fetch_chain`` reads them after the next frame's
predispatch has replayed; its header goes to pinned host memory in stream
order before any later replay, ``chain.dispatch_chain``), the analysis's
seven outputs in one clone (the pipeline holds several predispatched
analyses before it reads any), and the CDEF stage's planes and index map,
which its caller downloads.

All of a runner's graphs share its pool, so two keys' graphs may hold their
temporaries and outputs in the same memory.  That is safe because a runner
replays one key's graphs and copies out their results before it replays
anything else, all on one stream.  Captures use the thread-local capture
mode, so GOP workers (``api/channel.py``), each a pipeline on a stream of
its own, may pin memory and synchronize while another captures, and each
thread captures on a stream of its own (:func:`_capture_stream`).  The
kernels' launches inside a capture are counted at each replay
(``kernels.counting_capture``).

The runners live for the process, as the reference's ``lru_cache`` keeps
its compiled programs: a :class:`ProgramSet` (one runner of each kind)
is checked out of :data:`STORE` by a ``FramePipeline`` on its first device
run and returned when its stream ends, so a later pipeline on the device
replays from its first frame of each key.  A pipeline holds its set alone,
and a set moves on only after its holder's last copy-out: the argument
above holds across pipelines as it does across frames, once the next holder
is ordered behind the last one's work.  On a card the set's return records
an event on each stream its runners last ran on, and its next checkout
makes the new holder's stream wait on them (:meth:`ProgramStore.acquire`).
A key's graphs may so be captured in one thread and replayed on another
thread's stream, which CUDA allows: a graph is launched on whatever stream
its replay names.  A set whose holder raised inside a run is dropped, not
returned: a failed capture may leave a key half built.

On the CPU a runner runs the same calls eagerly, into the same static
buffers, and copies out the same outputs, so a CPU test sees a stale read,
also across pipelines that share a set.  There is no switch back to the
eager calls on a card: a capture or replay that fails raises, with a note
naming the program and the key.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from rav1e_tpu_torch.device import analysis, kernels
from rav1e_tpu_torch.device.chain import stage_calls
from rav1e_tpu_torch.device.filters import cdef_stage_core


def _empty_like(a, device):
    """Uninitialised tensors on ``device`` of the shapes and types of a
    numpy array or a tensor, or of each in a tuple of them."""
    if isinstance(a, tuple):
        return tuple(_empty_like(x, device) for x in a)
    dtype = (a.dtype if isinstance(a, torch.Tensor)
             else torch.from_numpy(np.empty(0, a.dtype)).dtype)
    return torch.empty(tuple(a.shape), dtype=dtype, device=device)


def _load(dst, a) -> None:
    """Copy a numpy array or a tensor (or each in a tuple) into the static
    ``dst``; from pinned memory without blocking on a card (the caching
    host allocator keeps the pinned buffer until the copy has run)."""
    if isinstance(dst, tuple):
        for d, x in zip(dst, a):
            _load(d, x)
        return
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a))
        if dst.device.type == "cuda":
            a = a.pin_memory()
    dst.copy_(a, non_blocking=True)


_CAPTURE = threading.local()


def _capture_stream(device) -> torch.cuda.Stream:
    """This thread's stream for captures on ``device``.  PyTorch hands out
    streams round robin from a pool of 32 per priority, so a stream taken
    for every pipeline would in time be another thread's work stream, and a
    capture on it would take in that thread's launches.  Captures take one
    stream per thread from the high-priority pool, which no work stream of
    the port draws from (``api/channel.py``, ``parallel/mesh.py``)."""
    streams = getattr(_CAPTURE, "streams", None)
    if streams is None:
        streams = _CAPTURE.streams = {}
    if device not in streams:
        streams[device] = torch.cuda.Stream(device, priority=-1)
    return streams[device]


def _copy_into(dst, src) -> None:
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    else:
        for a, b in zip(dst, src):
            _copy_into(a, b)


class Graph:
    """A captured call: its CUDA graph and the kernel launches it holds,
    which each replay counts."""

    def __init__(self, graph: torch.cuda.CUDAGraph, launches: dict):
        self.graph = graph
        self.launches = launches

    def replay(self) -> None:
        self.graph.replay()
        kernels.add_launches(self.launches)


class KeyPrograms:
    """The static buffers and graphs of one key."""

    def __init__(self, calls, data):
        self.calls = calls    # (output names, call reading data) per graph
        self.data = data      # the inputs, then every call's outputs by name
        self.graphs = None    # a Graph per call once captured
        self.eager = 0        # runs made eagerly
        self.captures = 0     # runs that captured the key's graphs
        self.replays = 0      # runs made as replays


def new_counts() -> dict:
    """A holder's counts of one runner's runs: eager, capturing (each also
    a replay) and replayed."""
    return {"eager": 0, "captures": 0, "replays": 0}


class Programs:
    """Calls run by key: on a card CUDA graphs per key after the key's first
    run, on the CPU the eager calls.  ``program`` names the runner in the
    note of a failed capture.  ``counts`` are the current holder's
    (:func:`new_counts`), which a pipeline swaps in when it checks the
    runner's set out; the keys' own counts are the runner's over every
    holder."""

    program = "device program"

    def __init__(self, device):
        self.device = torch.device(device)
        self._keys = {}
        self._pool = None
        self.counts = new_counts()
        self.stream = None    # the stream of the last run on a card
        self.failed = False   # a run raised: the runner may be half built

    def _run(self, key, inputs: dict, make_calls) -> dict:
        """Load ``inputs`` (name -> numpy array, tensor, or a tuple of them)
        into the key's static buffers and run its calls (``make_calls()``,
        asked for on the key's first run: (output names, call) pairs, each
        call reading the buffers by name and returning its outputs in the
        order of its names).  Returns the buffers, the calls' outputs among
        them."""
        try:
            return self._run_key(key, inputs, make_calls)
        except BaseException:
            self.failed = True
            raise

    def _run_key(self, key, inputs, make_calls) -> dict:
        k = self._keys.get(key)
        if k is None:
            k = KeyPrograms(make_calls(), {
                name: _empty_like(a, self.device)
                for name, a in inputs.items()})
            self._keys[key] = k
        d = k.data
        if self.device.type == "cuda":
            self.stream = torch.cuda.current_stream(self.device)
        for name, a in inputs.items():
            _load(d[name], a)
        if self.device.type == "cuda" and k.eager:
            if k.graphs is None:
                self._capture(key, k)
                k.captures += 1
                self.counts["captures"] += 1
            # on this thread's current stream, whichever thread captured
            for g in k.graphs:
                g.replay()
            k.replays += 1
            self.counts["replays"] += 1
        else:
            for names, call in k.calls:
                for name, v in zip(names, call(d)):
                    if name in d:
                        _copy_into(d[name], v)
                    else:
                        d[name] = v
            k.eager += 1
            self.counts["eager"] += 1
        return d

    def _capture(self, key, k: KeyPrograms) -> None:
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        d = k.data
        graphs = []
        with torch.cuda.device(self.device), \
                torch.cuda.stream(_capture_stream(self.device)):
            for names, call in k.calls:
                g = torch.cuda.CUDAGraph()
                try:
                    with kernels.counting_capture() as launches:
                        g.capture_begin(pool=self._pool,
                                        capture_error_mode="thread_local")
                        try:
                            out = call(d)
                        except BaseException:
                            # the capture is invalid already; the error says
                            # why
                            with contextlib.suppress(RuntimeError):
                                g.capture_end()
                            raise
                        g.capture_end()
                except BaseException as e:
                    e.add_note(f"while capturing the {self.program} of key "
                               f"{key}, the graph that makes "
                               f"{', '.join(names)}")
                    raise
                d.update(zip(names, out))
                graphs.append(Graph(g, launches))
        k.graphs = graphs

    def _describe(self, key) -> tuple:
        return tuple(key)

    def stats(self) -> dict:
        """Keys, keys captured, runs made eagerly, capturing and as
        replays (over every holder), the pool's bytes on the card, and per
        key its description with its eager and replayed runs."""
        ks = list(self._keys.values())
        return {
            "keys": len(ks),
            "captured": sum(k.graphs is not None for k in ks),
            "eager": sum(k.eager for k in ks),
            "captures": sum(k.captures for k in ks),
            "replays": sum(k.replays for k in ks),
            "pool_bytes": self.pool_bytes(),
            "by_key": [(*self._describe(key), k.eager, k.replays)
                       for key, k in self._keys.items()],
        }

    def pool_bytes(self) -> int:
        """Bytes the card holds for this runner's graph pool (0 before the
        first capture)."""
        if self._pool is None:
            return 0
        pool = tuple(self._pool)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s["segment_pool_id"]) == pool)


class ChainPrograms(Programs):
    """The chain stages of one pipeline, by (geometry, CDEF lists): five
    graphs per key."""

    program = "device chain"

    def run(self, geom, src_planes, ref_planes, aux, y_list, uv_list):
        """The chain for one frame: src_planes 3 SB-extent planes (numpy or
        device tensors), ref_planes ((y, u, v),) * 3 padded device planes,
        aux the packed int32 inputs (numpy), y_list/uv_list the CDEF
        candidate lists.  Returns (ref_out, hdr, levels): ref_out and levels
        are copies that later runs leave alone; hdr is the static header,
        to be copied out before the next run."""
        d = self._run(
            (geom, tuple(y_list), tuple(uv_list)),
            {"src": tuple(src_planes),
             "refs": tuple(tuple(r) for r in ref_planes), "aux": aux},
            lambda: stage_calls(geom, list(y_list), list(uv_list)))
        return (tuple(p.clone() for p in d["ref_out"]), d["hdr"],
                d["levels"].clone())

    def key(self, geom, y_list, uv_list):
        """The :class:`KeyPrograms` of a key (its static buffers with the
        last run's stage outputs by name, its graphs, its frame counts), or
        None before the key's first frame."""
        return self._keys.get((geom, tuple(y_list), tuple(uv_list)))

    def _describe(self, key):
        g, y, uv = key
        return (g.has_bwd, g.has_bwd2, y, uv)


class AnalysisPrograms(Programs):
    """The frame analysis of one pipeline, by (padded shape, bit depth,
    has_inter, has_bwd, has_bwd2): one graph per key.  The mesh path
    (``analysis._mesh_frame_analysis``) and the ``gaps`` diagnostics stay
    eager."""

    program = "frame analysis"

    def run(self, luma, ref0, ref1, ref2, q: float, lam: float, bd: int,
            flags):
        """The analysis of one frame: padded planes (device tensors of any
        integer type, as ``analysis.upload_source_luma`` makes them; the
        references a key does not read are not copied), the ac quantizer
        and lambda (host floats, loaded as float32), the bit depth and
        (has_inter, has_bwd, has_bwd2).  Returns the seven outputs
        (``analysis.analyze_finish``'s handle order) as views into one copy
        that later runs leave alone."""
        inputs = {"luma": luma, "qlam": np.array([q, lam], np.float32)}
        for name, plane, used in zip(("ref0", "ref1", "ref2"),
                                     (ref0, ref1, ref2), flags):
            if used:
                inputs[name] = plane
        shape = tuple(luma.shape)
        flags = tuple(flags)
        d = self._run(
            (shape, bd, *flags), inputs,
            lambda: [(("out",), lambda d: (
                analysis.analysis_call(d, bd, flags),))])
        return analysis.unpack_outputs(d["out"].clone(), shape)


class CdefPrograms(Programs):
    """The standalone CDEF stage of one pipeline (``filters.
    cdef_device_frame``), by (planes, grid, damping, bit depth, strength
    lists): one graph per key."""

    program = "CDEF stage"

    def run(self, planes, grid, damping: int, bd: int, rec_grids, src_grids,
            filt, y_str, uv_str):
        """``filters.cdef_stage_core`` on host arrays (``rec_grids``,
        ``src_grids``: a numpy plane each; ``filt``: the (nby, nbx) bool
        map), loaded from pinned memory.  Returns (outs, idx) in the
        runner's static memory: download them before the next run."""
        planes, grid = tuple(planes), tuple(grid)
        y_str, uv_str = tuple(y_str), tuple(uv_str)
        d = self._run(
            (planes, grid, damping, bd, y_str, uv_str),
            {"rec": tuple(rec_grids), "src": tuple(src_grids), "filt": filt},
            lambda: [(("outs", "idx"), lambda d: cdef_stage_core(
                planes, grid, damping, bd, d["rec"], d["src"], d["filt"],
                list(y_str), list(uv_str)))])
        return d["outs"], d["idx"]


class ProgramSet:
    """One runner of each kind, used together by one pipeline at a time:
    ``chain``, ``analysis`` and ``cdef``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.chain = ChainPrograms(device)
        self.analysis = AnalysisPrograms(device)
        self.cdef = CdefPrograms(device)
        self.ready = []       # events of the last holder's streams

    def runners(self) -> dict:
        """The runners by the name ``stats`` gives them."""
        return {"chain": self.chain, "analysis": self.analysis,
                "CDEF": self.cdef}

    @property
    def failed(self) -> bool:
        return any(r.failed for r in self.runners().values())

    def streams(self) -> set:
        """The streams the runners last ran on (none on the CPU)."""
        return {r.stream for r in self.runners().values()
                if r.stream is not None}

    def stats(self) -> dict:
        """Each runner's :meth:`Programs.stats`, by name."""
        return {name: r.stats() for name, r in self.runners().items()}

    def pool_bytes(self) -> int:
        return sum(r.pool_bytes() for r in self.runners().values())


class ProgramStore:
    """The sets of runners of a process, per device.  :meth:`acquire` hands
    out the idle set released last, or a new one, so a device never holds
    more sets than it had pipelines running at once; :meth:`release` takes
    a set back for the next pipeline.  Sets live for the process.

    Each runner's static buffers, its first run's outputs and its graph
    pool are allocated by the caching allocator on its first holder's
    stream and keep that stream's tag, which the allocator reads only when
    a block is freed.  None is freed while the set lives, except the eager
    outputs that a capture replaces, which no later holder's stream has
    touched, since a key runs eagerly once; so no ``record_stream`` is
    needed.  A dropped set is freed whole once its last holder's work has
    run (:meth:`_prune`).

    :meth:`release` may run in a garbage collection anywhere, inside
    another pipeline's capture or this store's own lock (which is
    reentrant for that), and so makes no call that a capture forbids: it
    records events, and waits on none."""

    def __init__(self):
        self._lock = threading.RLock()
        self._idle = {}      # device -> idle sets, the last released last
        self._sets = {}      # device -> every set not dropped
        self._dropped = []   # dropped sets whose last work may still run

    @staticmethod
    def _device(device) -> torch.device:
        d = torch.device(device)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        return d

    def acquire(self, device) -> ProgramSet:
        """A set of runners on ``device`` for the calling pipeline.  On a
        card its last holder's work is ordered before the current stream's,
        so no copy into its static buffers overtakes a replay or copy-out of
        the last holder."""
        device = self._device(device)
        self._prune()
        with self._lock:
            idle = self._idle.setdefault(device, [])
            pset = idle.pop() if idle else None
        if pset is None:
            pset = ProgramSet(device)
            with self._lock:
                self._sets.setdefault(device, []).append(pset)
        if pset.ready:
            stream = torch.cuda.current_stream(device)
            for event in pset.ready:
                stream.wait_event(event)
            pset.ready = []
        return pset

    def release(self, pset: ProgramSet) -> None:
        """Take ``pset`` back at its holder's end of stream, or drop it for
        good when a run of its holder raised."""
        events = []
        for stream in pset.streams():
            event = torch.cuda.Event()
            event.record(stream)
            events.append(event)
        pset.ready = events
        with self._lock:
            if pset.failed:
                self._sets[pset.device].remove(pset)
                self._dropped.append(pset)
            else:
                self._idle[pset.device].append(pset)

    def _prune(self) -> None:
        """Let go of the dropped sets whose last holder's work has run."""
        with self._lock:
            for pset in list(self._dropped):
                if all(e.query() for e in pset.ready):
                    self._dropped.remove(pset)

    def stats(self, device) -> dict:
        """Of ``device``: the sets, those in use, and each set's runner
        stats (:meth:`ProgramSet.stats`), and their pools' bytes in all."""
        device = self._device(device)
        with self._lock:
            sets = list(self._sets.get(device, []))
            idle = len(self._idle.get(device, []))
        return {"sets": len(sets), "in_use": len(sets) - idle,
                "by_set": [s.stats() for s in sets],
                "pool_bytes": sum(s.pool_bytes() for s in sets)}


# the process's store, which every FramePipeline checks its set out of
STORE = ProgramStore()
