"""Daala/od_ec multiply-free range coder — the AV1 symbol entropy coder.

Host-serial by nature (every symbol's coding interval depends on all prior
symbols), so in the TPU build this stays on CPU and is overlapped with device
compute; the RDO search paths avoid it entirely by using device-side rate
estimation against frozen CDF snapshots.

Behavioral counterpart of the reference's ``src/ec.rs``:

- three backends — :class:`WriterCounter` (bit counting only, the RDO "fake
  backend"), :class:`WriterRecorder` (token log, replayable; used to splice
  the CDEF index into an already-coded superblock stream), and
  :class:`WriterEncoder` (the real bitstream with carry propagation);
- ``checkpoint`` / ``rollback`` so mode search can rewind entropy state;
- Q15 *inverted* CDFs of at most 16 symbols: ``cdf[i] = 32768 - cum(i+1)``,
  monotonically decreasing, with the adaptation counter stored in the low
  6 bits of the final (zero) element;
- the normative CDF adaptation rule (AV1 spec 8.4.1 update process).

The matching range decoder (:class:`Reader`) implements the AV1 spec's
Symbol decoding process (spec 8.2.x) and backs the self-hosted round-trip
verification decoder in :mod:`rav1e_tpu.decoder`.
"""

from __future__ import annotations

from typing import List, Tuple

OD_BITRES = 3
EC_PROB_SHIFT = 6
EC_MIN_PROB = 4
_U32 = 0xFFFFFFFF


def update_cdf(cdf: List[int], val: int) -> None:
    """Adapt an inverted-Q15 CDF in place after coding symbol ``val``.

    The last element holds the adaptation counter in its low 6 bits
    (reference: ``ec.rs:935-955``; AV1 spec 8.4.1).
    """
    nsymbs = len(cdf)
    count = cdf[-1]
    rate = 3 + min(nsymbs >> 1, 2) + (count >> 4)
    cdf[-1] = count + 1 - (count >> 5)
    for i in range(nsymbs - 1):
        v = cdf[i]
        if i >= val:
            cdf[i] = v - (v >> rate)
        else:
            cdf[i] = v + ((32768 - v) >> rate)


def _lr_compute(rng: int, fl: int, fh: int, nms: int) -> Tuple[int, int]:
    """Split the current range for symbol interval [fl, fh) (inverted Q15).

    Returns ``(l, r)`` — the low offset and the new range width.
    """
    r = rng
    u = (((r >> 8) * (fl >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) + EC_MIN_PROB * nms
    if fl >= 32768:
        u = r
    v = (((r >> 8) * (fh >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) + EC_MIN_PROB * (nms - 1)
    return (r - u) & _U32, u - v


def _frac_compute(nbits_total: int, rng: int) -> int:
    """Fractional bits used, to OD_BITRES precision (``ec.rs:357-379``)."""
    nbits = nbits_total << OD_BITRES
    l = 0
    for _ in range(OD_BITRES):
        rng = (rng * rng) >> 15
        b = rng >> 16
        l = (l << 1) | b
        rng >>= b
    return nbits - l


def _leading_zeros16_of_range(r: int) -> int:
    """Number of leading zeros of ``r`` as a u16 (r in [1, 65535])."""
    return 16 - r.bit_length()


def _recenter(r: int, v: int) -> int:
    if v > (r << 1):
        return v
    elif v >= r:
        return (v - r) << 1
    else:
        return ((r - v) << 1) - 1


class Checkpoint:
    __slots__ = ("stream_size", "backend_var", "rng", "cnt", "fake_bits_frac")

    def __init__(self, stream_size, backend_var, rng, cnt, fake_bits_frac):
        self.stream_size = stream_size
        self.backend_var = backend_var
        self.rng = rng
        self.cnt = cnt
        self.fake_bits_frac = fake_bits_frac


class WriterBase:
    """Shared symbol-level interface over a storage backend."""

    def __init__(self):
        self.rng = 0x8000
        self.cnt = -9
        self.fake_bits_frac = 0

    # -- backend interface (overridden) --------------------------------------

    def store(self, fl: int, fh: int, nms: int) -> None:
        raise NotImplementedError

    def stream_bits(self) -> int:
        raise NotImplementedError

    def checkpoint(self) -> Checkpoint:
        raise NotImplementedError

    def rollback(self, ckpt: Checkpoint) -> None:
        raise NotImplementedError

    # -- symbol layer ---------------------------------------------------------

    def symbol(self, s: int, cdf) -> None:
        """Code symbol ``s`` against inverted-Q15 ``cdf`` (unchanged)."""
        nms = len(cdf) - s
        fl = cdf[s - 1] if s > 0 else 32768
        fh = cdf[s]
        self.store(fl, fh, nms)

    def symbol_with_update(self, s: int, cdf: List[int]) -> None:
        """Code ``s`` then adapt ``cdf`` in place.

        CDF undo-logging for RDO rollback lives in the ContextWriter layer
        (cf. reference ``CDFContextLog``), not here.
        """
        self.symbol(s, cdf)
        update_cdf(cdf, s)

    def bool(self, val: bool, f: int) -> None:
        """Code a boolean with P(true) = f/32768."""
        self.symbol(1 if val else 0, (f, 0))

    def bit(self, bit: int) -> None:
        self.bool(bit == 1, 16384)

    def literal(self, bits: int, s: int) -> None:
        for b in range(bits - 1, -1, -1):
            self.bit((s >> b) & 1)

    def write_golomb(self, level: int) -> None:
        x = level + 1
        length = x.bit_length()
        for _ in range(length - 1):
            self.bit(0)
        for i in range(length - 1, -1, -1):
            self.bit((x >> i) & 1)

    def write_quniform(self, n: int, v: int) -> None:
        if n > 1:
            l = n.bit_length()
            m = (1 << l) - n
            if v < m:
                self.literal(l - 1, v)
            else:
                self.literal(l - 1, m + ((v - m) >> 1))
                self.literal(1, (v - m) & 1)

    def count_quniform(self, n: int, v: int) -> int:
        bits = 0
        if n > 1:
            l = n.bit_length()
            m = (1 << l) - n
            bits += (l - 1) << OD_BITRES
            if v >= m:
                bits += 1 << OD_BITRES
        return bits

    def write_subexp(self, n: int, k: int, v: int) -> None:
        i = 0
        mk = 0
        while True:
            b = k + i - 1 if i != 0 else k
            a = 1 << b
            if n <= mk + 3 * a:
                self.write_quniform(n - mk, v - mk)
                break
            t = v >= mk + a
            self.bool(t, 16384)
            if t:
                i += 1
                mk += a
            else:
                self.literal(b, v - mk)
                break

    def count_subexp(self, n: int, k: int, v: int) -> int:
        i = 0
        mk = 0
        bits = 0
        while True:
            b = k + i - 1 if i != 0 else k
            a = 1 << b
            if n <= mk + 3 * a:
                bits += self.count_quniform(n - mk, v - mk)
                break
            bits += 1 << OD_BITRES
            if v >= mk + a:
                i += 1
                mk += a
            else:
                bits += b << OD_BITRES
                break
        return bits

    def write_unsigned_subexp_with_ref(self, v: int, n: int, k: int, r: int) -> None:
        if (r << 1) <= n:
            self.write_subexp(n, k, _recenter(r, v))
        else:
            self.write_subexp(n, k, _recenter(n - 1 - r, n - 1 - v))

    def count_unsigned_subexp_with_ref(self, v: int, n: int, k: int, r: int) -> int:
        if (r << 1) <= n:
            return self.count_subexp(n, k, _recenter(r, v))
        return self.count_subexp(n, k, _recenter(n - 1 - r, n - 1 - v))

    def write_signed_subexp_with_ref(self, v: int, low: int, high: int, k: int, r: int) -> None:
        self.write_unsigned_subexp_with_ref(v - low, high - low, k, r - low)

    def count_signed_subexp_with_ref(self, v: int, low: int, high: int, k: int, r: int) -> int:
        return self.count_unsigned_subexp_with_ref(v - low, high - low, k, r - low)

    # -- cost telling ---------------------------------------------------------

    def symbol_bits(self, s: int, cdf) -> int:
        """Approximate fractional-bit cost of coding ``s`` now (``ec.rs:572``)."""
        rng8 = self.rng >> 8
        fh = cdf[s] >> EC_PROB_SHIFT
        if s > 0:
            fl = cdf[s - 1] >> EC_PROB_SHIFT
            r = ((rng8 * fl) >> (7 - EC_PROB_SHIFT)) - (
                (rng8 * fh) >> (7 - EC_PROB_SHIFT)
            ) + EC_MIN_PROB
        else:
            nms1 = len(cdf) - s - 1
            r = self.rng - ((rng8 * fh) >> (7 - EC_PROB_SHIFT)) - nms1 * EC_MIN_PROB
        bits = 0
        pre = _frac_compute(self.cnt + 9, self.rng)
        d = _leading_zeros16_of_range(r)
        c = self.cnt
        sh = c + d
        if sh >= 0:
            c += 16
            if sh >= 8:
                bits += 8
                c -= 8
            bits += 8
            sh = c + d - 24
        return _frac_compute(bits + sh + 9, r << d) - pre

    def add_bits_frac(self, bits_frac: int) -> None:
        self.fake_bits_frac += bits_frac

    def tell(self) -> int:
        return self.stream_bits() + self.cnt + 10 + (self.fake_bits_frac >> 8)

    def tell_frac(self) -> int:
        return _frac_compute(self.tell(), self.rng) + self.fake_bits_frac


class WriterCounter(WriterBase):
    """Counts bits only — the RDO rate-estimation backend (``ec.rs:193``)."""

    def __init__(self):
        super().__init__()
        self.bits = 0

    def store(self, fl: int, fh: int, nms: int) -> None:
        _l, r = _lr_compute(self.rng, fl, fh, nms)
        d = _leading_zeros16_of_range(r)
        self.bits += d
        self.rng = (r << d) & 0xFFFF

    def stream_bits(self) -> int:
        return self.bits

    def checkpoint(self) -> Checkpoint:
        return Checkpoint(self.bits, 0, self.rng, self.cnt, self.fake_bits_frac)

    def rollback(self, c: Checkpoint) -> None:
        self.rng = c.rng
        self.bits = c.stream_size
        self.fake_bits_frac = c.fake_bits_frac


class WriterRecorder(WriterBase):
    """Records (fl, fh, nms) tokens for later replay (``ec.rs:228``)."""

    def __init__(self):
        super().__init__()
        self.storage: List[Tuple[int, int, int]] = []
        self.bits = 0

    def store(self, fl: int, fh: int, nms: int) -> None:
        _l, r = _lr_compute(self.rng, fl, fh, nms)
        d = _leading_zeros16_of_range(r)
        self.bits += d
        self.rng = (r << d) & 0xFFFF
        self.storage.append((fl, fh, nms))

    def stream_bits(self) -> int:
        return self.bits

    def checkpoint(self) -> Checkpoint:
        return Checkpoint(self.bits, len(self.storage), self.rng, self.cnt, self.fake_bits_frac)

    def rollback(self, c: Checkpoint) -> None:
        self.rng = c.rng
        self.cnt = c.cnt
        self.bits = c.stream_size
        del self.storage[c.backend_var :]
        self.fake_bits_frac = c.fake_bits_frac

    def replay(self, dest: WriterBase) -> None:
        """Splice recorded tokens into ``dest`` and reset (``ec.rs:418``)."""
        for fl, fh, nms in self.storage:
            dest.store(fl, fh, nms)
        self.rng = 0x8000
        self.cnt = -9
        self.storage.clear()
        self.bits = 0


class WriterEncoder(WriterBase):
    """Produces the actual range-coded bitstream (``ec.rs:264``)."""

    def __init__(self):
        super().__init__()
        self.precarry: List[int] = []  # u16 bytes-with-carry
        self.low = 0  # u32 window

    def store(self, fl: int, fh: int, nms: int) -> None:
        l, r = _lr_compute(self.rng, fl, fh, nms)
        low = (l + self.low) & _U32
        c = self.cnt
        d = _leading_zeros16_of_range(r)
        s = c + d
        if s >= 0:
            c += 16
            m = (1 << c) - 1
            if s >= 8:
                self.precarry.append((low >> c) & 0xFFFF)
                low &= m
                c -= 8
                m >>= 8
            self.precarry.append((low >> c) & 0xFFFF)
            s = c + d - 24
            low &= m
        self.low = (low << d) & _U32
        self.rng = (r << d) & 0xFFFF
        self.cnt = s

    def stream_bits(self) -> int:
        return len(self.precarry) * 8

    def checkpoint(self) -> Checkpoint:
        return Checkpoint(len(self.precarry), self.low, self.rng, self.cnt, self.fake_bits_frac)

    def rollback(self, c: Checkpoint) -> None:
        self.rng = c.rng
        self.cnt = c.cnt
        self.low = c.backend_var
        del self.precarry[c.stream_size :]
        self.fake_bits_frac = c.fake_bits_frac

    def done(self) -> bytes:
        """Flush and return the final bitstream (``ec.rs:434-473``)."""
        l = self.low
        c = self.cnt
        s = 10
        m = 0x3FFF
        e = ((l + m) & ~m & _U32) | (m + 1)
        s += c
        if s > 0:
            n = (1 << (c + 16)) - 1
            while True:
                self.precarry.append((e >> (c + 16)) & 0xFFFF)
                e &= n
                s -= 8
                c -= 8
                n >>= 8
                if s <= 0:
                    break
        # resolve carries back-to-front
        carry = 0
        out = bytearray(len(self.precarry))
        for i in range(len(self.precarry) - 1, -1, -1):
            carry += self.precarry[i]
            out[i] = carry & 0xFF
            carry >>= 8
        return bytes(out)


# ---------------------------------------------------------------------------
# Range decoder (AV1 spec symbol decoding process; cf. the test-only Reader
# in the reference's ec.rs:965-1056 which validates against the same scheme)
# ---------------------------------------------------------------------------

_WINDOW_SIZE = 32
_LOTS_OF_BITS = 0x4000


class Reader:
    """Range decoder over a byte buffer, matching :class:`WriterEncoder`."""

    __slots__ = ("buf", "bptr", "dif", "rng", "cnt")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.bptr = 0
        self.dif = (1 << (_WINDOW_SIZE - 1)) - 1
        self.rng = 0x8000
        self.cnt = -15
        self._refill()

    def _refill(self) -> None:
        s = _WINDOW_SIZE - 9 - (self.cnt + 15)
        while s >= 0 and self.bptr < len(self.buf):
            self.dif ^= self.buf[self.bptr] << s
            self.cnt += 8
            s -= 8
            self.bptr += 1
        if self.bptr >= len(self.buf):
            self.cnt = _LOTS_OF_BITS

    def _normalize(self, dif: int, rng: int) -> None:
        d = 16 - rng.bit_length()
        self.cnt -= d
        self.dif = (((dif + 1) << d) - 1) & _U32
        self.rng = (rng << d) & 0xFFFF
        if self.cnt < 0:
            self._refill()

    def read_bool(self, f: int) -> bool:
        r = self.rng
        v = (((r >> 8) * (f >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) + EC_MIN_PROB
        vw = v << (_WINDOW_SIZE - 16)
        if self.dif >= vw:
            dif, rng, ret = self.dif - vw, r - v, False
        else:
            dif, rng, ret = self.dif, v, True
        self._normalize(dif, rng)
        return ret

    def read_bit(self) -> int:
        return 1 if self.read_bool(16384) else 0

    def read_symbol(self, cdf) -> int:
        """Decode one symbol against an inverted-Q15 CDF (unchanged)."""
        r = self.rng
        n = len(cdf) - 1
        c = self.dif >> (_WINDOW_SIZE - 16)
        ret = 0
        u = r
        v = (((r >> 8) * (cdf[0] >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) + EC_MIN_PROB * n
        while c < v:
            u = v
            ret += 1
            v = (((r >> 8) * (cdf[ret] >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) + EC_MIN_PROB * (
                n - ret
            )
        dif = self.dif - (v << (_WINDOW_SIZE - 16))
        self._normalize(dif, u - v)
        return ret

    def read_symbol_with_update(self, cdf: List[int]) -> int:
        s = self.read_symbol(cdf)
        update_cdf(cdf, s)
        return s

    def read_literal(self, bits: int) -> int:
        v = 0
        for _ in range(bits):
            v = (v << 1) | self.read_bit()
        return v

    def read_golomb(self) -> int:
        length = 1
        while self.read_bit() == 0:
            length += 1
            assert length <= 32
        x = 1
        for _ in range(length - 1):
            x = (x << 1) | self.read_bit()
        return x - 1

    def read_quniform(self, n: int) -> int:
        if n <= 1:
            return 0
        l = n.bit_length()
        m = (1 << l) - n
        v = self.read_literal(l - 1)
        if v < m:
            return v
        return (v << 1) - m + self.read_literal(1)

    def read_subexp(self, n: int, k: int) -> int:
        i = 0
        mk = 0
        while True:
            b = k + i - 1 if i != 0 else k
            a = 1 << b
            if n <= mk + 3 * a:
                return mk + self.read_quniform(n - mk)
            if self.read_bool(16384):
                i += 1
                mk += a
            else:
                return mk + self.read_literal(b)

    def read_unsigned_subexp_with_ref(self, n: int, k: int, r: int) -> int:
        if (r << 1) <= n:
            return _inv_recenter(r, self.read_subexp(n, k))
        return n - 1 - _inv_recenter(n - 1 - r, self.read_subexp(n, k))

    def read_signed_subexp_with_ref(self, low: int, high: int, k: int, r: int) -> int:
        return low + self.read_unsigned_subexp_with_ref(high - low, k, r - low)

    def tell(self) -> int:
        return self.bptr * 8 - max(self.cnt, 0)


def _inv_recenter(r: int, v: int) -> int:
    if v > (r << 1):
        return v
    elif v & 1:
        return r - ((v + 1) >> 1)
    else:
        return r + (v >> 1)
