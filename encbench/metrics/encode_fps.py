"""Frames whose packets the caller received inside the window, over the
window's seconds (all the window's work and time)."""


def read(obs):
    return obs.frames / obs.window_s if obs.window_s > 0 else None
