"""Parallelism layer of the port (counterpart of ray_tpu/parallel): the mesh
description and the function that makes the training step.  One device so
far: a mesh with any axis larger than 1 raises until the multi-device
slice."""

from .mesh import MeshSpec, build_mesh
from .spmd import make_lm_eval_step, make_lm_train_step

__all__ = ["MeshSpec", "build_mesh", "make_lm_train_step",
           "make_lm_eval_step"]
