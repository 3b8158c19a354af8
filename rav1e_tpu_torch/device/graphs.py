"""The device chain as replayed programs: each of its five stages one CUDA
graph per (geometry, CDEF candidate lists).  Counterpart of
``rav1e_tpu/device/chain.py`` ``chain_stages_jit``, the reference's five
compiled programs per geometry.

Run eagerly, a bidirectional 1080p chain frame is some 14,500 PyTorch
launches, and the host launching them, not the card, sets the frame's pace.
:class:`ChainPrograms`, one per ``FramePipeline``, keeps for every key static
input buffers (the three source planes, the 3 x 3 padded reference planes,
the packed ``aux``) into which each dispatch copies its inputs.  The first
frame of a key runs the stages eagerly; that also makes every device
constant the stages read (``constants.device_cache``), which a capture
cannot do.  The second frame captures each stage as a graph, on a side
stream, into the runner's memory pool, and from then on a frame is five
replays on the pipeline's current stream.  Each stage's outputs stay in the
pool, where the next stage's graph reads them.

What must outlive the next replay is copied out right after the replay: the
padded reconstruction (the next frames' reference) and the levels buffer
(``chain.fetch_chain`` reads it when the levels prefix falls short, after
the next frame's predispatch has replayed).  The header and the levels
prefix go to pinned host memory in stream order before any later replay
(``chain.dispatch_chain``).

All of a runner's graphs share its pool, so two keys' graphs may hold their
temporaries and outputs in the same memory.  That is safe because a runner
replays one key's five stages and copies out their results before it
replays anything else, all on one stream.  Captures use the thread-local
capture mode, so GOP workers (``api/channel.py``), each a pipeline on a
stream of its own, may pin memory and synchronize while another captures,
and each thread captures on a stream of its own (:func:`_capture_stream`).

On the CPU the runner runs the same stage functions eagerly, into the same
static buffers, and copies out the same outputs, so a CPU test sees a stale
read.  There is no switch back to the eager stages on a card: a capture or
replay that fails raises.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from rav1e_tpu_torch.device.chain import stage_calls


def _empty_like(a, device) -> torch.Tensor:
    """An uninitialised tensor on ``device`` of the shape and type of a
    numpy array or a tensor."""
    dtype = (a.dtype if isinstance(a, torch.Tensor)
             else torch.from_numpy(np.empty(0, a.dtype)).dtype)
    return torch.empty(tuple(a.shape), dtype=dtype, device=device)


def _load(dst: torch.Tensor, a) -> None:
    """Copy a numpy array or a tensor into the static ``dst``; from pinned
    memory without blocking on a card (the caching host allocator keeps
    the pinned buffer until the copy has run)."""
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


class KeyPrograms:
    """The static buffers and graphs of one (geometry, CDEF lists) key."""

    def __init__(self, calls, data):
        self.calls = calls    # chain.stage_calls: (output names, call) x 5
        self.data = data      # the inputs, then every stage output by name
        self.graphs = None    # the five graphs once captured
        self.eager = 0        # frames run eagerly
        self.replays = 0      # frames run as five replays


class ChainPrograms:
    """The chain stages of one pipeline, by key: on a card five CUDA graphs
    per key after the key's first frame, on the CPU the eager stages."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._keys = {}
        self._pool = None

    def run(self, geom, src_planes, ref_planes, aux, y_list, uv_list):
        """The chain for one frame: src_planes 3 SB-extent planes (numpy or
        device tensors), ref_planes ((y, u, v),) * 3 padded device planes,
        aux the packed int32 inputs (numpy), y_list/uv_list the CDEF
        candidate lists.  Returns (ref_out, hdr, levels): ref_out and levels
        are copies that later runs leave alone; hdr is the static header,
        to be copied out before the next run."""
        k = self.key(geom, y_list, uv_list)
        if k is None:
            data = {
                "src": tuple(_empty_like(a, self.device) for a in src_planes),
                "refs": tuple(tuple(_empty_like(a, self.device) for a in r)
                              for r in ref_planes),
                "aux": _empty_like(aux, self.device),
            }
            k = KeyPrograms(stage_calls(geom, list(y_list), list(uv_list)),
                            data)
            self._keys[(geom, tuple(y_list), tuple(uv_list))] = k
        d = k.data
        for dst, a in zip(d["src"], src_planes):
            _load(dst, a)
        for dst3, r3 in zip(d["refs"], ref_planes):
            for dst, a in zip(dst3, r3):
                _load(dst, a)
        _load(d["aux"], aux)
        if self.device.type == "cuda" and k.eager:
            if k.graphs is None:
                self._capture(k)
            for g in k.graphs:
                g.replay()
            k.replays += 1
        else:
            for names, call in k.calls:
                for name, v in zip(names, call(d)):
                    if name in d:
                        _copy_into(d[name], v)
                    else:
                        d[name] = v
            k.eager += 1
        return (tuple(p.clone() for p in d["ref_out"]), d["hdr"],
                d["levels"].clone())

    def key(self, geom, y_list, uv_list):
        """The :class:`KeyPrograms` of a key (its static buffers with the
        last run's stage outputs by name, its graphs, its frame counts), or
        None before the key's first frame."""
        return self._keys.get((geom, tuple(y_list), tuple(uv_list)))

    def _capture(self, k: KeyPrograms) -> None:
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        d = k.data
        graphs = []
        with torch.cuda.device(self.device), \
                torch.cuda.stream(_capture_stream(self.device)):
            for names, call in k.calls:
                g = torch.cuda.CUDAGraph()
                g.capture_begin(pool=self._pool,
                                capture_error_mode="thread_local")
                try:
                    out = call(d)
                except BaseException as e:
                    e.add_note(f"while capturing the chain stage that makes "
                               f"{', '.join(names)}")
                    try:
                        g.capture_end()
                    except RuntimeError:
                        pass  # the capture is invalid already; e says why
                    raise
                g.capture_end()
                d.update(zip(names, out))
                graphs.append(g)
        k.graphs = graphs

    def stats(self) -> dict:
        """Keys, keys captured, frames run eagerly and as replays, the
        pool's bytes on the card, and per key (has_bwd, has_bwd2, y_list,
        uv_list, eager frames, replayed frames)."""
        ks = list(self._keys.values())
        return {
            "keys": len(ks),
            "captured": sum(k.graphs is not None for k in ks),
            "eager": sum(k.eager for k in ks),
            "replays": sum(k.replays for k in ks),
            "pool_bytes": self.pool_bytes(),
            "by_key": [(g.has_bwd, g.has_bwd2, y, uv, k.eager, k.replays)
                       for (g, y, uv), k in self._keys.items()],
        }

    def pool_bytes(self) -> int:
        """Bytes the card holds for this runner's graph pool (0 before the
        first capture)."""
        if self._pool is None:
            return 0
        pool = tuple(self._pool)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s["segment_pool_id"]) == pool)
