"""Distribution over ``torch.distributed`` ranks: the build and serving
meshes of the sharded WoW build and mesh serving (``core.distributed``),
the LM's logical sharding rules (``logical``) and input and cache specs,
and the tensor and expert parallelism of its forward over ``model``
(``tensor_parallel``) and its expert parallelism over ``data``."""
from .logical import (
    RULES_DP_ONLY, RULES_EP_DATA, RULES_TP_FSDP, ModelPart, PartitionSpec,
    batch_axes, expert_data_leaves, fsdp_axes, fsdp_spec, model_dim,
    model_parts, param_shardings, spec_for,
)
from .sharding import (
    BuildMesh, RankMesh, build_mesh, cache_sharding, seq_shard_axis,
    serving_mesh, token_sharding,
)
from .tensor_parallel import ExpertSplit, ModelSplit

__all__ = ["BuildMesh", "RankMesh", "build_mesh", "serving_mesh",
           "PartitionSpec", "RULES_TP_FSDP", "RULES_DP_ONLY",
           "RULES_EP_DATA", "spec_for", "param_shardings", "batch_axes",
           "ModelPart", "ModelSplit", "ExpertSplit", "expert_data_leaves",
           "fsdp_axes", "fsdp_spec", "model_dim", "model_parts",
           "token_sharding", "seq_shard_axis", "cache_sharding"]
