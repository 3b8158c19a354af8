"""Seconds from the start of the run's script to the window's first frame:
imports, the CUDA context, loading (in a checkout's first run, building) the
kernels and the native coder, drawing the clip, and the warm-up encode that
runs each of the cell's keys eagerly and captures it."""


def read(obs):
    return obs.setup_s
