from encbench.reference.av1.utils.math import (
    align_power_of_two,
    align_power_of_two_and_shift,
    ceil_div,
    clamp,
    ilog,
    msb,
    round_shift,
    round_up_pow2,
)

__all__ = [
    "align_power_of_two",
    "align_power_of_two_and_shift",
    "ceil_div",
    "clamp",
    "ilog",
    "msb",
    "round_shift",
    "round_up_pow2",
]
