"""ray_tpu_torch.data — streaming datasets feeding the card (counterpart
of ray_tpu/data): blocks, ``Dataset`` with its streaming executor over the
port's tasks, the readers and writers, batch iteration and the prefetching
host-to-card iterator.  Importing it imports neither torch nor pyarrow."""

from .block import Block, BlockAccessor
from .dataset import (Dataset, GroupedDataset, from_arrow, from_items,
                      from_numpy, from_pandas, range, read_binary_files,
                      read_csv, read_images, read_json, read_parquet,
                      read_tfrecord)
from .iterator import device_put_iterator, iter_batches

__all__ = [
    "Dataset", "GroupedDataset", "Block", "BlockAccessor", "range",
    "from_arrow", "from_items", "from_numpy", "from_pandas",
    "read_parquet", "read_csv",
    "read_binary_files", "read_images", "read_tfrecord",
    "read_json", "iter_batches", "device_put_iterator",
]
