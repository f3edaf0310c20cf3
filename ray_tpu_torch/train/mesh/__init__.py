"""Mesh runtime: build the worker mesh, place trees onto it, and restore a
checkpoint onto another mesh shape (counterpart of ray_tpu/train/mesh)."""
