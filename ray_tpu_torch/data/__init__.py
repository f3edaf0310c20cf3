"""Data feeding of the port (counterpart of ray_tpu/data): numpy blocks,
batch iteration and the prefetching host-to-card iterator."""

from .block import Block, BlockAccessor
from .iterator import device_put_iterator, iter_batches

__all__ = ["Block", "BlockAccessor", "iter_batches", "device_put_iterator"]
