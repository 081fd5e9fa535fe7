"""engine.captures_after_warmup.ingest: ``engine.captures_after_warmup``
in the ingest cells, where the device build's new shapes capture and each
capture stalls an apply."""
from wowbench import spec

read = spec.load_reader("engine.captures_after_warmup")
