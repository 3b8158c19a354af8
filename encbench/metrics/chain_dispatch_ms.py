"""Mean milliseconds of the program's ``chain_dispatch`` span, per
chain-coded frame of the window."""


def read(obs):
    if obs.spans is None:
        return None
    d = [b - a for n, a, b in obs.spans if n == "chain_dispatch"]
    return sum(d) / len(d) * 1e3 if d else None
