"""Milliseconds per window frame in which no span of the program was open:
the window's wall time less the union of the spans (any thread) in it."""


def read(obs):
    if obs.spans is None or not obs.frames:
        return None
    covered, end = 0.0, obs.t0
    ivs = sorted((max(a, obs.t0), min(b, obs.t1)) for _n, a, b in obs.spans)
    for a, b in ivs:
        if b <= end:
            continue
        covered += b - max(a, end)
        end = b
    return (obs.window_s - covered) / obs.frames * 1e3
