"""Milliseconds per window frame in the program's ``device_analysis`` span."""


def read(obs):
    if obs.spans is None or not obs.frames:
        return None
    return sum(min(b, obs.t1) - max(a, obs.t0) for n, a, b in obs.spans
               if n == "device_analysis") / obs.frames * 1e3
