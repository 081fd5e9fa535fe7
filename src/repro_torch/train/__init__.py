"""Training substrate on torch (the port of ``repro.train``): optimizer,
loop, checkpointing, data, elasticity; ``compress`` and ``pipeline`` hold
the compressed reduction and GPipe over ``torch.distributed`` ranks."""
from .checkpoint import AsyncCheckpointer, latest_step, restore, save
from .data import DataConfig, TokenSource
from .elastic import Coordinator, shard_rows
from .optimizer import AdamW, AdamWState
from .train_loop import Trainer, jit_train_step, make_train_step

__all__ = [
    "AdamW", "AdamWState", "make_train_step", "jit_train_step", "Trainer",
    "save", "restore", "latest_step", "AsyncCheckpointer",
    "DataConfig", "TokenSource", "Coordinator", "shard_rows",
]
