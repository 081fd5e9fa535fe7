"""search.hops_per_query: mean hops (``Reply.hops``) of the window's
replies."""
import numpy as np


def read(r):
    q = r.requests
    done = np.isfinite(q["t_reply"])
    return float(q["hops"][done].mean()) if done.any() else None
