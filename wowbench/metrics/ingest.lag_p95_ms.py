"""ingest.lag_p95_ms: the 95th percentile, over every ingest micro-batch
that arrived in the window, of its arrival (on the mix's schedule) to the
step after which the engine no longer held it: applied, so searchable.
Those still held at the close are finished and timed after it; one never
applied counts as +inf (host clock).  The batches that arrived inside the
traced slice are left out: the profiler slows the host work of their
applies."""
import numpy as np


def read(r):
    if r.ingest is None:
        return None
    lag = r.ingest["lag_s"]
    if r.trace is not None:
        lag = lag[r.ingest["arrival"] < r.trace["t0"]]
    if not len(lag):
        return None
    p95 = float(np.percentile(np.minimum(lag, 1e30), 95))
    return p95 * 1e3 if p95 < 1e29 else float("inf")
