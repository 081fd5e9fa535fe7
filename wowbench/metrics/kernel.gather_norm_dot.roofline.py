"""kernel.gather_norm_dot.roofline: the least time the serving hops'
``gather_norm_dot`` work needs at the card's HBM rate, over the device
time of the kernel's events in the traced slice, in %.

The work is that of the requests sent inside the slice, from what their
replies report: for each distance computation (``Reply.dc``) one stored
row of ``d`` values, its int64 id and the two f32 outputs, and for each
hop (``Reply.hops``) a f32 query row.  In a closed loop at a steady state
the work sent in a slice is the work done in it, to within the requests
that straddle its two ends, which the slice of many request lifetimes
makes small.  Gathers of finished or padding rows in a replayed chunk are
not counted, so they lower the share.  The kernel's operations (2 d a
row) are far below the f32 peak's share of its time; bytes bound it.
"""
import numpy as np

from wowbench import peaks

BYTES_PER_VALUE = {"f32": 4, "bf16": 2, "int8": 1}


def read(r):
    t = r.trace
    if t is None:
        return None
    dev = sum(s for name, s in t["device_s"].items()
              if "gather_norm_dot" in name)
    q = r.requests
    sent = (q["t_submit"] >= t["t0"]) & (q["t_submit"] < t["t1"])
    if dev <= 0 or not sent.any():
        return None
    d = r.cfg["d"]
    row = d * BYTES_PER_VALUE[r.cfg["index"]["vec_dtype"]]
    if r.cfg["index"]["vec_dtype"] == "int8":
        row += 4  # the row's f32 scale
    dc = int(q["dc"][sent].sum())
    hops = int(q["hops"][sent].sum())
    nbytes = dc * (row + 8 + 8) + hops * 4 * d
    return 100.0 * nbytes / peaks.HBM_BW / dev
