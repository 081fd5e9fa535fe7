"""ingest.read_p95_ms: ``latency_p95_ms`` of the reads beside the ingest
stream: the stall that each apply puts on them.  Per-layer there for the
reason ``ingest.read_qps`` gives."""
from wowbench import spec

read = spec.load_reader("latency_p95_ms")
