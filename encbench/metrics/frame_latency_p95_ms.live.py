"""The 95th percentile (nearest rank) of each window frame's time from the
send_frame call that gave it to the receive_packet call that returned its
shown packet."""

import math


def read(obs):
    lat = sorted(obs.latencies_s)
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
