"""engine.wave_rows: requests served over waves assembled in the window
(``ServeEngine.engine_stats``): how wide the engine's waves run."""


def read(r):
    waves = r.engine["waves"]
    return r.engine["served"] / waves if waves else None
