"""device.idle_share: the share of the traced slice in which no kernel,
copy or set ran on the card, from the profiler's trace (prelude left
out), in %."""


def read(r):
    t = r.trace
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
