"""y4m (YUV4MPEG2) reader/writer (reference: src/bin/decoder/y4m.rs)."""

from __future__ import annotations

from typing import BinaryIO, Optional

import numpy as np

from rav1e_tpu_torch.config import ChromaSampling

_COLORSPACES = {
    "420": (ChromaSampling.Cs420, 8),
    "420jpeg": (ChromaSampling.Cs420, 8),
    "420mpeg2": (ChromaSampling.Cs420, 8),
    "420paldv": (ChromaSampling.Cs420, 8),
    "422": (ChromaSampling.Cs422, 8),
    "444": (ChromaSampling.Cs444, 8),
    "mono": (ChromaSampling.Cs400, 8),
    "420p10": (ChromaSampling.Cs420, 10),
    "422p10": (ChromaSampling.Cs422, 10),
    "444p10": (ChromaSampling.Cs444, 10),
    "420p12": (ChromaSampling.Cs420, 12),
    "422p12": (ChromaSampling.Cs422, 12),
    "444p12": (ChromaSampling.Cs444, 12),
}


class Y4MReader:
    def __init__(self, f: BinaryIO):
        self.f = f
        header = b""
        while not header.endswith(b"\n"):
            c = f.read(1)
            if not c:
                raise ValueError("empty y4m stream")
            header += c
        parts = header.decode().strip().split(" ")
        if parts[0] != "YUV4MPEG2":
            raise ValueError("not a y4m stream")
        self.width = self.height = 0
        self.fps_num, self.fps_den = 30, 1
        self.chroma_sampling = ChromaSampling.Cs420
        self.bit_depth = 8
        self.aspect = (1, 1)
        for p in parts[1:]:
            tag, val = p[0], p[1:]
            if tag == "W":
                self.width = int(val)
            elif tag == "H":
                self.height = int(val)
            elif tag == "F":
                n, d = val.split(":")
                self.fps_num, self.fps_den = int(n), int(d)
            elif tag == "C":
                if val not in _COLORSPACES:
                    raise ValueError(f"unsupported colorspace {val}")
                self.chroma_sampling, self.bit_depth = _COLORSPACES[val]
            elif tag == "A":
                n, d = val.split(":")
                if int(n) and int(d):
                    self.aspect = (int(n), int(d))
        if not self.width or not self.height:
            raise ValueError("missing y4m dimensions")

    def _plane_dims(self, idx: int):
        if idx == 0:
            return self.width, self.height
        xd, yd = self.chroma_sampling.decimation()
        return -(-self.width // (1 << xd)), -(-self.height // (1 << yd))

    def read_frame(self) -> Optional[list]:
        line = self.f.readline()
        if not line:
            return None
        if not line.startswith(b"FRAME"):
            raise ValueError("bad y4m frame marker")
        nplanes = 1 if self.chroma_sampling == ChromaSampling.Cs400 else 3
        dtype = np.uint8 if self.bit_depth == 8 else np.uint16
        bytes_per = 1 if self.bit_depth == 8 else 2
        planes = []
        for i in range(nplanes):
            w, h = self._plane_dims(i)
            raw = self.f.read(w * h * bytes_per)
            if len(raw) < w * h * bytes_per:
                return None
            arr = np.frombuffer(raw, dtype="<u1" if bytes_per == 1 else "<u2")
            planes.append(arr.reshape(h, w).astype(dtype))
        return planes

    def __iter__(self):
        while True:
            planes = self.read_frame()
            if planes is None:
                return
            yield planes


class Y4MWriter:
    def __init__(self, f: BinaryIO, width, height, fps_num, fps_den, chroma_sampling, bit_depth):
        self.f = f
        self.chroma_sampling = chroma_sampling
        self.bit_depth = bit_depth
        cs_name = {
            (ChromaSampling.Cs420, 8): "420",
            (ChromaSampling.Cs422, 8): "422",
            (ChromaSampling.Cs444, 8): "444",
            (ChromaSampling.Cs400, 8): "mono",
            (ChromaSampling.Cs420, 10): "420p10",
            (ChromaSampling.Cs422, 10): "422p10",
            (ChromaSampling.Cs444, 10): "444p10",
            (ChromaSampling.Cs420, 12): "420p12",
            (ChromaSampling.Cs422, 12): "422p12",
            (ChromaSampling.Cs444, 12): "444p12",
        }[(chroma_sampling, bit_depth)]
        f.write(f"YUV4MPEG2 W{width} H{height} F{fps_num}:{fps_den} Ip A1:1 C{cs_name}\n".encode())

    def write_frame(self, planes) -> None:
        self.f.write(b"FRAME\n")
        for arr in planes:
            if self.bit_depth == 8:
                self.f.write(arr.astype("<u1").tobytes())
            else:
                self.f.write(arr.astype("<u2").tobytes())
