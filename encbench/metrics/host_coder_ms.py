"""Milliseconds per window frame in the host coder's spans:
``encode_tiles`` + ``chain_replay_code`` + ``lrf_decide``."""

SPANS = ("encode_tiles", "chain_replay_code", "lrf_decide")


def read(obs):
    if obs.spans is None or not obs.frames:
        return None
    return sum(min(b, obs.t1) - max(a, obs.t0) for n, a, b in obs.spans
               if n in SPANS) / obs.frames * 1e3
