"""Frame and Plane containers.

Host-side pixel storage, the counterpart of the reference's ``v_frame``
re-export (``src/frame/mod.rs:49``) and its padded allocation
(``FrameAlloc::new`` pads luma by ``SB_SIZE + DEBLOCK + PAD``, see
``frame/mod.rs:22-70``).

Design notes (TPU-first):

- A :class:`Plane` is a single numpy array sized to a whole number of
  superblocks plus a replicated border.  Keeping the device-visible extent a
  static, superblock-aligned shape means every jitted kernel sees one fixed
  shape per (resolution, subsampling) pair — no dynamic shapes reach XLA.
- ``data`` is the padded array; ``as_array()`` views the visible
  ``height x width`` window.  Borders are edge-replicated (``pad()``) exactly
  like the reference so motion search beyond frame edges is well-defined.
- dtype is ``uint8`` for 8-bit and ``uint16`` for 10/12-bit content;
  transforms/quantization promote to ``int32`` on device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

# Superblock geometry. We always operate with 64x64 superblocks (the reference
# likewise fixes SB_SIZE_LOG2 = 6, src/context/mod.rs).
SB_SIZE_LOG2 = 6
SB_SIZE = 1 << SB_SIZE_LOG2

# Padding beyond the coded area (covers deblock taps + subpel MC reach + ME
# range headroom, mirroring the reference's luma padding policy).
PLANE_PADDING = SB_SIZE + 16 + 8


def _np_dtype_for_bit_depth(bit_depth: int):
    return np.uint8 if bit_depth == 8 else np.uint16


@dataclass
class PlaneConfig:
    """Geometry of one plane: visible size, subsampling, padding & alignment."""

    width: int
    height: int
    xdec: int  # chroma decimation log2 in x (0 for luma)
    ydec: int  # chroma decimation log2 in y
    pad: int = PLANE_PADDING

    @property
    def alloc_width(self) -> int:
        # visible area rounded up to superblock multiple (in plane units),
        # plus border on both sides
        sb = SB_SIZE >> self.xdec
        vis = -(-self.width // sb) * sb
        return vis + 2 * self.pad

    @property
    def alloc_height(self) -> int:
        sb = SB_SIZE >> self.ydec
        vis = -(-self.height // sb) * sb
        return vis + 2 * self.pad


class Plane:
    """A padded pixel plane.

    ``self.data`` has shape ``(cfg.alloc_height, cfg.alloc_width)``; the
    visible origin is at ``(cfg.pad, cfg.pad)``.
    """

    __slots__ = ("cfg", "data", "bit_depth")

    def __init__(self, cfg: PlaneConfig, bit_depth: int = 8, data: Optional[np.ndarray] = None):
        self.cfg = cfg
        self.bit_depth = bit_depth
        if data is None:
            self.data = np.zeros(
                (cfg.alloc_height, cfg.alloc_width), dtype=_np_dtype_for_bit_depth(bit_depth)
            )
        else:
            assert data.shape == (cfg.alloc_height, cfg.alloc_width)
            self.data = data

    @classmethod
    def new(cls, width: int, height: int, xdec: int = 0, ydec: int = 0, bit_depth: int = 8) -> "Plane":
        return cls(PlaneConfig(width, height, xdec, ydec), bit_depth)

    # ---- views ------------------------------------------------------------

    def as_array(self) -> np.ndarray:
        """Visible-area view (height x width), writable."""
        p = self.cfg.pad
        return self.data[p : p + self.cfg.height, p : p + self.cfg.width]

    def padded_visible(self) -> np.ndarray:
        """Superblock-aligned visible view (includes right/bottom SB padding)."""
        p = self.cfg.pad
        return self.data[p : self.cfg.alloc_height - p, p : self.cfg.alloc_width - p]

    def region(self, x: int, y: int, w: int, h: int) -> np.ndarray:
        """View of a ``w x h`` rectangle at visible coordinates ``(x, y)``.

        Coordinates may be negative / extend past the visible area as long as
        they stay inside the allocation (the padded border).
        """
        p = self.cfg.pad
        return self.data[p + y : p + y + h, p + x : p + x + w]

    def row(self, y: int) -> np.ndarray:
        p = self.cfg.pad
        return self.data[p + y, p : p + self.cfg.width]

    # ---- mutation ---------------------------------------------------------

    def copy_from(self, arr: np.ndarray) -> None:
        """Fill the visible area from ``arr`` then replicate edges."""
        assert arr.shape == (self.cfg.height, self.cfg.width), (
            arr.shape,
            (self.cfg.height, self.cfg.width),
        )
        self.as_array()[:] = arr
        self.pad()

    def pad(self) -> None:
        """Edge-replicate the visible area into the full allocation."""
        p = self.cfg.pad
        h, w = self.cfg.height, self.cfg.width
        d = self.data
        # left/right columns
        d[p : p + h, :p] = d[p : p + h, p : p + 1]
        d[p : p + h, p + w :] = d[p : p + h, p + w - 1 : p + w]
        # top/bottom rows (full width, after columns are done)
        d[:p] = d[p : p + 1]
        d[p + h :] = d[p + h - 1 : p + h]

    def copy(self) -> "Plane":
        return Plane(self.cfg, self.bit_depth, self.data.copy())

    # ---- resampling (lookahead pyramids) ----------------------------------

    def downsampled_2x(self) -> "Plane":
        """2x box-filter downsample (used for the half/quarter-res ME pyramid,
        counterpart of the reference's ``Plane::downsampled``)."""
        w2 = (self.cfg.width + 1) // 2
        h2 = (self.cfg.height + 1) // 2
        out = Plane.new(w2, h2, self.cfg.xdec, self.cfg.ydec, self.bit_depth)
        src = self.region(0, 0, 2 * w2, 2 * h2).astype(np.uint32)
        ds = (src[0::2, 0::2] + src[0::2, 1::2] + src[1::2, 0::2] + src[1::2, 1::2] + 2) >> 2
        out.copy_from(ds.astype(self.data.dtype))
        return out


@dataclass
class FrameParameters:
    """Per-frame encode parameters (reference: ``frame/mod.rs:39-47``)."""

    frame_type_override: "str | None" = None  # None / "key" / "no"
    opaque: object = None
    t35_metadata: tuple = ()


class Frame:
    """A YUV frame: one luma plane plus 0 or 2 chroma planes."""

    __slots__ = ("planes", "bit_depth")

    def __init__(self, planes, bit_depth: int):
        self.planes = planes
        self.bit_depth = bit_depth

    @classmethod
    def new(cls, width: int, height: int, chroma_sampling, bit_depth: int = 8) -> "Frame":
        # chroma_sampling is a ChromaSampling enum (imported lazily to avoid cycle)
        xdec, ydec = chroma_sampling.decimation()
        planes = [Plane.new(width, height, 0, 0, bit_depth)]
        if not chroma_sampling.is_monochrome():
            cw = -(-width // (1 << xdec))
            ch = -(-height // (1 << ydec))
            for _ in range(2):
                planes.append(Plane.new(cw, ch, xdec, ydec, bit_depth))
        f = cls.__new__(cls)
        f.planes = planes
        f.bit_depth = bit_depth
        return f

    def copy(self) -> "Frame":
        f = Frame.__new__(Frame)
        f.planes = [p.copy() for p in self.planes]
        f.bit_depth = self.bit_depth
        return f

    def pad(self) -> None:
        for p in self.planes:
            p.pad()
