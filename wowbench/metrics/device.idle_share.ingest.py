"""device.idle_share.ingest: ``device.idle_share`` in the ingest cells,
where it moves ``ingest_rows_per_s``."""
from wowbench import spec

read = spec.load_reader("device.idle_share")
