"""Small integer-math helpers shared across the encoder.

Behavioral counterparts of the reference's ``src/util/math.rs`` /
``src/transform/mod.rs:317`` (``av1_round_shift_array``): AV1 is an
integer-exact codec, so every rounding rule here is normative.  These helpers
are dtype-polymorphic: they accept Python ints, numpy arrays, and jax arrays
(all ops are ``+ >> <<`` so they trace cleanly under ``jit``).
"""

from __future__ import annotations


def clamp(v, lo, hi):
    """Clamp ``v`` into ``[lo, hi]`` (works on ints and arrays)."""
    if hasattr(v, "clip"):
        return v.clip(lo, hi)
    return lo if v < lo else hi if v > hi else v


def round_shift(value, bit: int):
    """AV1 normative rounding right-shift: ``(value + (1 << (bit-1))) >> bit``.

    ``bit`` must be >= 1 for actual rounding; ``bit == 0`` returns the value
    unchanged (matching the reference's behavior for 0 shifts).
    """
    if bit == 0:
        return value
    return (value + (1 << (bit - 1))) >> bit


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up_pow2(x: int, align_log2: int) -> int:
    """Round ``x`` up to a multiple of ``1 << align_log2``."""
    mask = (1 << align_log2) - 1
    return (x + mask) & ~mask


def align_power_of_two(x: int, n: int) -> int:
    return round_up_pow2(x, n)


def align_power_of_two_and_shift(x: int, n: int) -> int:
    return (x + (1 << n) - 1) >> n


def msb(x: int) -> int:
    """Index of the most significant set bit. ``x`` must be > 0."""
    assert x > 0
    return x.bit_length() - 1


def ilog(x: int) -> int:
    """Number of bits needed to represent ``x`` (0 -> 0), i.e. floor(log2(x))+1."""
    return x.bit_length()
