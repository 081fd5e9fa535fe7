"""wowbench: the benchmark of the PyTorch and CUDA port of WoW
(``repro_torch``), a range-filtered vector index served through its
``ServeEngine`` on one card.

``python -m wowbench --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` (``__main__``).  The cells,
configurations, traffic mixes and metrics are files found by name
(``spec``); the base index is built once a checkout and loaded
(``index_cache``); the data and traffic are made from the seed (``data``,
``loadgen`` and the generator a mix names under ``generators``);
``reference`` decides ``correct``; ``tracing`` reads the
profiler; ``peaks`` holds the card's published rates.  Nothing here
imports ``jax`` or the JAX package ``repro``, and ``reference`` imports
nothing of ``repro_torch``.
"""
