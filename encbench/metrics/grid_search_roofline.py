"""grid_search's share of its roofline in the window: the least time its
launches could take (encbench/bounds.py, from the rounds' shapes at the
cell's frame size) over the device time of its kernel records in the
profiler's trace, in percent."""

KERNEL = "grid_search_kernel"


def read(obs):
    if obs.device_events is None or not obs.kernel_bound_s:
        return None
    d = [b - a for n, a, b in obs.device_events
         if KERNEL in n and b > obs.t0 and a < obs.t1]
    if not d:
        return None
    return 100.0 * len(d) * obs.kernel_bound_s["grid_search"] / sum(d)
