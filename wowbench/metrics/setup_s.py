"""setup_s: process start to the window's first submit: data, the device
build of the base index, the engine, its warm-up and warm-up ingest."""


def read(r):
    return r.setup_s
