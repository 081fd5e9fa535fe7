"""search.dc_per_query: mean distance computations (``Reply.dc``) of the
window's replies."""
import numpy as np


def read(r):
    q = r.requests
    done = np.isfinite(q["t_reply"])
    return float(q["dc"][done].mean()) if done.any() else None
