"""Distribution over ``torch.distributed`` ranks: the build and serving
meshes of the sharded WoW build and mesh serving (``core.distributed``),
and the LM's logical sharding rules (``logical``) and input and cache
specs."""
from .logical import (
    RULES_DP_ONLY, RULES_EP_DATA, RULES_TP_FSDP, PartitionSpec, batch_axes,
    param_shardings, spec_for,
)
from .sharding import (
    BuildMesh, RankMesh, build_mesh, cache_sharding, seq_shard_axis,
    serving_mesh, token_sharding,
)

__all__ = ["BuildMesh", "RankMesh", "build_mesh", "serving_mesh",
           "PartitionSpec", "RULES_TP_FSDP", "RULES_DP_ONLY",
           "RULES_EP_DATA", "spec_for", "param_shardings", "batch_axes",
           "token_sharding", "seq_shard_axis", "cache_sharding"]
