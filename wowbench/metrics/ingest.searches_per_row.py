"""ingest.searches_per_row: construction searches of the device build
(``index.build_stats.searches``) in the window, over the rows applied in
it."""


def read(r):
    if r.ingest is None or not r.ingest["rows"]:
        return None
    return r.ingest["searches"] / r.ingest["rows"]
