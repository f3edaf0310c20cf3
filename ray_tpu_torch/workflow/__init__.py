"""Workflows are deprecated, matching the JAX package's tombstone
(ray_tpu/workflow/__init__.py) and the reference's."""

raise ImportError(
    "ray_tpu_torch.workflow has been deprecated, mirroring Ray's removal of "
    "the workflow library. Use tasks + actors with checkpointing instead.")
