"""MSB-first bit I/O for uncompressed headers (OBU syntax).

Counterpart of the reference's use of ``bitstream_io::BitWriter`` plus its
ULEB128 extension (header.rs:91-139) and quasi-uniform/subexponential codes
(ec.rs:841-918 BCodeWriter).
"""

from __future__ import annotations


class BitWriter:
    def __init__(self):
        self.bytes = bytearray()
        self.bitbuf = 0
        self.nbits = 0

    def write_bit(self, b: int) -> None:
        self.bitbuf = (self.bitbuf << 1) | (b & 1)
        self.nbits += 1
        if self.nbits == 8:
            self.bytes.append(self.bitbuf)
            self.bitbuf = 0
            self.nbits = 0

    def write(self, nbits: int, value: int) -> None:
        for i in range(nbits - 1, -1, -1):
            self.write_bit((value >> i) & 1)

    def write_signed(self, nbits: int, value: int) -> None:
        """Two's-complement signed write (bitstream-io write_signed)."""
        self.write(nbits, value & ((1 << nbits) - 1))

    def write_uleb128(self, value: int) -> None:
        while True:
            byte = value & 0x7F
            value >>= 7
            if value:
                self.write(8, byte | 0x80)
            else:
                self.write(8, byte)
                break

    def write_quniform(self, n: int, v: int) -> None:
        if n > 1:
            l = n.bit_length()
            m = (1 << l) - n
            if v < m:
                self.write(l - 1, v)
            else:
                self.write(l - 1, m + ((v - m) >> 1))
                self.write(1, (v - m) & 1)

    def _recenter_finite_nonneg(self, n: int, r: int, v: int) -> int:
        def recenter(r, v):
            if v > (r << 1):
                return v
            elif v >= r:
                return (v - r) << 1
            return ((r - v) << 1) - 1

        if (r << 1) <= n:
            return recenter(r, v)
        return recenter(n - 1 - r, n - 1 - v)

    def write_subexpfin(self, n: int, k: int, v: int) -> None:
        i = 0
        mk = 0
        while True:
            b = k + i - 1 if i > 0 else k
            a = 1 << b
            if n <= mk + 3 * a:
                self.write_quniform(n - mk, v - mk)
                return
            t = v >= mk + a
            self.write_bit(int(t))
            if t:
                i += 1
                mk += a
            else:
                self.write(b, v - mk)
                return

    def write_s_refsubexpfin(self, n: int, k: int, r: int, v: int) -> None:
        n2 = (n << 1) - 1
        rr = r + (n - 1)
        vv = v + (n - 1)
        self.write_subexpfin(n2, k, self._recenter_finite_nonneg(n2, rr, vv))

    def byte_align(self) -> None:
        while self.nbits:
            self.write_bit(0)

    def done(self) -> bytes:
        assert self.nbits == 0, "stream not byte aligned"
        return bytes(self.bytes)

    def tell_bits(self) -> int:
        return len(self.bytes) * 8 + self.nbits


class BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position

    def read_bit(self) -> int:
        byte = self.data[self.pos >> 3]
        bit = (byte >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return bit

    def read(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            v = (v << 1) | self.read_bit()
        return v

    def read_signed(self, nbits: int) -> int:
        v = self.read(nbits)
        if v >= 1 << (nbits - 1):
            v -= 1 << nbits
        return v

    def read_uleb128(self) -> int:
        value = 0
        for i in range(8):
            byte = self.read(8)
            value |= (byte & 0x7F) << (7 * i)
            if not (byte & 0x80):
                break
        return value

    def read_quniform(self, n: int) -> int:
        if n <= 1:
            return 0
        l = n.bit_length()
        m = (1 << l) - n
        v = self.read(l - 1)
        if v < m:
            return v
        return (v << 1) - m + self.read(1)

    def byte_align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def bytes_consumed(self) -> int:
        return (self.pos + 7) >> 3


def uleb128(value: int) -> bytes:
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)
