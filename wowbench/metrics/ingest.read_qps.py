"""ingest.read_qps: ``qps`` of the reads beside the ingest stream (full-
budget replies that came back inside the window, over its seconds).  It
is a per-layer metric there: with applies holding the scheduler most of
the time, two runs of one seed lie further apart than a bound of 25% or
less allows (PERF.md, section 2)."""
from wowbench import spec

read = spec.load_reader("qps")
