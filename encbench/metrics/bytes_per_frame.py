"""Compressed bytes per frame over the clip's first ``fixed_frames`` frames,
which every run encodes whole: the same frames whatever the window's length
or the program's speed."""


def read(obs):
    return obs.fixed_bytes / obs.fixed_frames if obs.fixed_frames else None
