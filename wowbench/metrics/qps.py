"""qps: replies of full-budget requests that came back inside the window,
over the window's seconds (host clock)."""
import numpy as np


def read(r):
    q = r.requests
    done = (q["t_reply"] <= r.t_close) & ~q["degraded"]
    return float(np.sum(done)) / r.window_s
