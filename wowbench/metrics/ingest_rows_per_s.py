"""ingest_rows_per_s: rows whose apply completed (searchable) inside the
window, over the window's seconds (host clock); nothing without ingest."""


def read(r):
    if r.ingest is None:
        return None
    return r.ingest["rows"] / r.window_s
