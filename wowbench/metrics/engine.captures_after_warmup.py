"""engine.captures_after_warmup: CUDA-graph captures reported to
``repro_torch.monitoring`` inside the window, after ``warmup()`` and any
warm-up ingest; each stalls the step that meets a new chunk shape."""


def read(r):
    return r.captures
