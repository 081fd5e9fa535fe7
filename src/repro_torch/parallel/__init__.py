"""Distribution over ``torch.distributed`` ranks: the build and serving
meshes of the sharded WoW build and mesh serving (``core.distributed``)."""
from .sharding import BuildMesh, RankMesh, build_mesh, serving_mesh

__all__ = ["BuildMesh", "RankMesh", "build_mesh", "serving_mesh"]
