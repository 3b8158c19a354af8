"""Push-style channel API with optional GOP-parallel encoding.

Capability counterpart of the reference's ``src/api/channel/``
(``Config::new_channel``, ``by_gop.rs``): frames go into a
:class:`FrameSender`, packets come out of a :class:`PacketReceiver` in
order.  With ``Config.parallel_gops > 1`` the input is split into GOP
chunks at keyframe boundaries, encoded by a worker pool, and reassembled
in order (by_gop.rs:81-260).  Workers overlap where the native hot loops
release the GIL; the same structure maps to per-chip GOP slots on a
device mesh.

In the PyTorch port, the GOP workers of a CUDA config share one card, each
on a CUDA stream of its own (see ``_worker_stream``).
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Iterator, List, Optional

from rav1e_tpu_torch.api.util import EncoderStatus, Packet


class FrameSender:
    def __init__(self, q: queue.Queue, ctx_template):
        self._q = q
        self._ctx = ctx_template
        self._closed = False

    def new_frame(self):
        return self._ctx.new_frame()

    def send(self, frame) -> None:
        if self._closed:
            raise EncoderStatus.EnoughData()
        self._q.put(frame)

    def close(self) -> None:
        """Finish the stream (reference: dropping the sender flushes)."""
        if not self._closed:
            self._closed = True
            self._q.put(None)


class PacketReceiver:
    def __init__(self, out_q: queue.Queue):
        self._q = out_q

    def __iter__(self) -> Iterator[Packet]:
        while True:
            item = self._q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item


def new_channel(config) -> "tuple[FrameSender, PacketReceiver]":
    """Build a (sender, receiver) pair for ``config``
    (reference api/channel/mod.rs:54)."""
    if config.parallel_gops > 1:
        return _new_by_gop_channel(config, config.parallel_gops)
    return _new_serial_channel(config)


def _drain(ctx, emit) -> None:
    while True:
        try:
            emit(ctx.receive_packet())
        except EncoderStatus.NeedMoreData:
            return
        except EncoderStatus.LimitReached:
            return


def _new_serial_channel(config):
    in_q: queue.Queue = queue.Queue(maxsize=32)
    out_q: queue.Queue = queue.Queue()
    ctx = config.new_context()

    def worker():
        try:
            while True:
                frame = in_q.get()
                if frame is None:
                    break
                ctx.send_frame(frame)
                _drain(ctx, out_q.put)
            ctx.flush()
            while True:
                try:
                    out_q.put(ctx.receive_packet())
                except EncoderStatus.LimitReached:
                    break
                except EncoderStatus.NeedMoreData:
                    break
        except Exception as e:  # propagate to the receiver
            out_q.put(e)
        finally:
            out_q.put(None)

    threading.Thread(target=worker, daemon=True, name="rav1e-tpu-enc").start()
    return FrameSender(in_q, ctx), PacketReceiver(out_q)


def _new_by_gop_channel(config, slots: int):
    """GOP-parallel: split input into keyframe-aligned chunks, encode each in
    its own context/worker, reassemble packets in order (by_gop.rs:81-260).

    Chunks are fixed at ``max_key_frame_interval`` frames, so every chunk
    starts at a keyframe by construction.
    """
    gop_len = max(int(config.enc.max_key_frame_interval), 1)
    in_q: queue.Queue = queue.Queue(maxsize=slots * gop_len + 4)
    out_q: queue.Queue = queue.Queue()
    template_ctx = config.new_context()

    chunk_q: queue.Queue = queue.Queue(maxsize=slots)
    results: dict = {}
    results_lock = threading.Condition()

    def splitter():
        chunk: List = []
        chunk_idx = 0
        frameno = 0
        while True:
            frame = in_q.get()
            if frame is None:
                break
            chunk.append(frame)
            frameno += 1
            if len(chunk) >= gop_len:
                chunk_q.put((chunk_idx, chunk))
                chunk_idx += 1
                chunk = []
        if chunk:
            chunk_q.put((chunk_idx, chunk))
            chunk_idx += 1
        for _ in range(slots):
            chunk_q.put(None)
        with results_lock:
            results["__total__"] = chunk_idx
            results_lock.notify_all()

    def worker():
        # The native coder keeps its scratch thread_local; its per-process
        # ME settings (g_me_method / g_me_range in native/enc.cc) are set
        # from the config by every context, so they hold the same values in
        # every worker of this channel.
        with _worker_stream(config):
            _work()

    def _work():
        while True:
            item = chunk_q.get()
            if item is None:
                return
            idx, frames = item
            try:
                ctx = config.new_context()
                pkts: List[Packet] = []
                base = idx * gop_len
                for f in frames:
                    ctx.send_frame(f)
                    _drain(ctx, pkts.append)
                ctx.flush()
                while True:
                    try:
                        pkts.append(ctx.receive_packet())
                    except (EncoderStatus.LimitReached, EncoderStatus.NeedMoreData):
                        break
                for p in pkts:
                    p.input_frameno += base
                result = pkts
            except Exception as e:
                result = e
            with results_lock:
                results[idx] = result
                results_lock.notify_all()

    def reassembler():
        next_idx = 0
        while True:
            with results_lock:
                while next_idx not in results and (
                    "__total__" not in results or next_idx < results["__total__"]
                ):
                    results_lock.wait()
                if "__total__" in results and next_idx >= results["__total__"]:
                    break
                result = results.pop(next_idx)
            if isinstance(result, Exception):
                out_q.put(result)
                break
            for p in result:
                out_q.put(p)
            next_idx += 1
        out_q.put(None)

    threading.Thread(target=splitter, daemon=True).start()
    for _ in range(slots):
        threading.Thread(target=worker, daemon=True).start()
    threading.Thread(target=reassembler, daemon=True).start()
    return FrameSender(in_q, template_ctx), PacketReceiver(out_q)


def _worker_stream(config):
    """On a CUDA device, a context that makes a new CUDA stream current in
    the calling thread (the current stream is thread-local); nothing on the
    CPU.  The kernels launch on ``torch.cuda.current_stream()``, and the
    chain's pinned copies and its ready event are enqueued there too, so a
    worker's device work stays on its stream.  No device tensor passes from
    one worker to another: each builds its own context, and the shared
    caches of device constants wait for their stream before they are
    shared (``device.constants.device_cache``).  Each worker's pipeline
    captures its chain graphs on a stream of its own in the thread-local
    capture mode (``device.graphs``), so the other workers' pinned copies
    and synchronizes go on during a capture."""
    import torch

    dev = torch.device(config.device)
    if dev.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.stream(torch.cuda.Stream(dev))
