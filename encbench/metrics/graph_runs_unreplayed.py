"""Runs of the program's replayed programs (chain, analysis, CDEF) inside
the window that were not replays of a captured graph: eager plus capturing
runs, from ``FramePipeline.program_stats``. 0 once the cell is warm."""


def read(obs):
    if obs.program_runs is None:
        return None
    return sum(d["eager"] + d["captures"] for d in obs.program_runs.values())
