"""Percent of the window in which no operation ran on the device: 1 less
the union of the profiler's device activities over the window."""


def read(obs):
    if obs.device_events is None or obs.window_s <= 0:
        return None
    from encbench import devtrace

    return 100.0 * (1.0 - devtrace.busy_s(obs.device_events, obs.t0, obs.t1)
                    / obs.window_s)
