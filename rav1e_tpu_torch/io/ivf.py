"""IVF container muxing (reference: workspace crate ivf/, src/bin/muxer/ivf.rs)."""

from __future__ import annotations

import struct
from typing import BinaryIO, Iterator, Tuple


class IvfWriter:
    def __init__(self, f: BinaryIO, width: int, height: int, framerate_num: int, framerate_den: int):
        self.f = f
        self.frame_count = 0
        self._count_pos = None
        header = struct.pack(
            "<4sHH4sHHIII4x",
            b"DKIF",
            0,  # version
            32,  # header length
            b"AV01",
            width,
            height,
            framerate_num,
            framerate_den,
            0,  # frame count (patched on close)
        )
        self._count_offset = 24
        f.write(header)

    def write_frame(self, data: bytes, pts: int) -> None:
        self.f.write(struct.pack("<IQ", len(data), pts))
        self.f.write(data)
        self.frame_count += 1

    def close(self) -> None:
        if self.f.seekable():
            self.f.seek(self._count_offset)
            self.f.write(struct.pack("<I", self.frame_count))
            self.f.seek(0, 2)


def read_ivf(f: BinaryIO) -> Iterator[Tuple[int, bytes]]:
    """Yields (pts, frame_data)."""
    header = f.read(32)
    magic, _ver, hdr_len = struct.unpack("<4sHH", header[:8])
    if magic != b"DKIF":
        raise ValueError("not an IVF file")
    f.seek(hdr_len)
    while True:
        fh = f.read(12)
        if len(fh) < 12:
            return
        size, pts = struct.unpack("<IQ", fh)
        data = f.read(size)
        if len(data) < size:
            raise ValueError("truncated IVF frame")
        yield pts, data
