"""WoW — Window-to-Window incremental RFANNS index (the paper's core).

The host index (``index``, ``graph``, ``wbt``, ``search``, ``store``,
``snapshot``) is numpy; ``device_search`` serves snapshots on a torch
device through the CUDA kernels in ``repro_torch.kernels``."""
from .datasets import Workload, make_workload, recall
from .index import WoWIndex, WoWParams
from .oracle import FlatNSW, brute_force, build_oracle_graph
from .store import BuildStats, SearchStats, VectorStore
from .wbt import WBT

__all__ = [
    "WBT",
    "WoWIndex",
    "WoWParams",
    "VectorStore",
    "SearchStats",
    "BuildStats",
    "FlatNSW",
    "brute_force",
    "build_oracle_graph",
    "Workload",
    "make_workload",
    "recall",
]
