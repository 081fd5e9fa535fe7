"""latency_p95_ms: the 95th percentile, over every request submitted in
the window, of submit to the return of the step that produced its reply
(host clock); a request rejected, expired or never answered counts as
+inf, and those in flight at the close are drained and timed."""
import numpy as np


def read(r):
    q = r.requests
    lat = np.where(q["degraded"], np.inf, q["t_reply"] - q["t_submit"])
    if not len(lat):
        return None
    p95 = float(np.percentile(np.minimum(lat, 1e30), 95))
    return p95 * 1e3 if p95 < 1e29 else float("inf")
