"""Parallelism layer of the port (counterpart of ray_tpu/parallel): the mesh
over a torch.distributed world, the logical-axis sharding rules, the
training step on one device or sharded over a mesh, and the GPipe
pipeline over its pp axis."""

from .mesh import MeshSpec, build_mesh
from .spmd import make_lm_eval_step, make_lm_train_step

__all__ = ["MeshSpec", "build_mesh", "make_lm_train_step",
           "make_lm_eval_step"]
