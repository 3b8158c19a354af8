"""Share (%) of the window's inter frames that the device chain coded: the
program's ``inter_chain`` counters (zero-length spans, one for each inter
frame the chain coded) over those and its ``inter_host`` counters (one for
each inter frame the host tile coder coded), in the window. None untraced,
or when the program opens neither counter (a program without them)."""


def read(obs):
    if obs.spans is None:
        return None
    n = {"inter_chain": 0, "inter_host": 0}
    for name, a, _b in obs.spans:
        if name in n and obs.t0 <= a <= obs.t1:
            n[name] += 1
    total = n["inter_chain"] + n["inter_host"]
    return 100.0 * n["inter_chain"] / total if total else None
