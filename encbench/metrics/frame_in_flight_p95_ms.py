"""The 95th percentile (nearest rank) of the shown frames' times in flight
that end in the window, in milliseconds, as the program times them: from
the ``send_frame`` that took a frame to the ``receive_packet`` that returned
its packet. The program records the two ends as zero-length spans,
``frame_in_flight_start`` and then ``frame_in_flight_end``, one right after
the other; each end in the window pairs with the start recorded last before
it. None untraced, or when the program records no such pair (a program
without them)."""

import math


def read(obs):
    if obs.spans is None:
        return None
    d, start = [], None
    for name, a, _b in obs.spans:
        if name == "frame_in_flight_start":
            start = a
        elif name == "frame_in_flight_end" and start is not None:
            if obs.t0 < a <= obs.t1:
                d.append(a - start)
            start = None
    if not d:
        return None
    d.sort()
    return d[math.ceil(0.95 * len(d)) - 1] * 1e3
