"""Blocks: the unit of distributed data (a copy of
ray_tpu/data/block.py, whose reference analog is python/ray/data/block.py
+ _internal/arrow_block.py).  Two physical block layouts behind one
accessor:

- numpy blocks (column dict of ndarrays), the default: columns pickle out
  of band into the task store's shared memory and feed
  ``device_put_iterator``'s pinned host copies without conversion.
- Arrow blocks (``pyarrow.Table``), enabled per pipeline with
  ``DataContext.block_format = "arrow"``: parquet/csv/json scans stay
  zero-copy end to end (Table slice/take/concat are metadata operations
  over shared buffers, and pickle-5 ships the buffers out of band), with
  numpy conversion deferred to the consumer boundary
  (``iter_batches(batch_format="numpy")``, ``device_put_iterator``).

pyarrow (and pandas) are imported only where an Arrow block or a pandas
frame is made, so ``import ray_tpu_torch.data`` works without them.
BlockAccessor dispatches on the block's physical type, so every stage
works with either layout.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

# A block is either a Dict[str, np.ndarray] or a pyarrow.Table.
Block = Any


def _is_arrow(block: Any) -> bool:
    # Cheap structural check: pyarrow import stays lazy for numpy-only
    # pipelines.
    return type(block).__module__.startswith("pyarrow")


def _normalize(item: Any) -> Dict[str, Any]:
    if isinstance(item, dict):
        return item
    return {"item": item}


class BlockAccessor:
    def __init__(self, block: Block):
        self._b = block
        self._arrow = _is_arrow(block)

    @staticmethod
    def from_rows(rows: Sequence[Dict[str, Any]]) -> Block:
        if not rows:
            return {}
        cols: Dict[str, List[Any]] = {k: [] for k in rows[0]}
        for r in rows:
            for k in cols:
                cols[k].append(r[k])
        return {k: np.asarray(v) for k, v in cols.items()}

    @staticmethod
    def from_arrow(table, block_format: Optional[str] = None) -> Block:
        """Table -> block in the pipeline's configured layout: the
        identity under block_format="arrow" (zero-copy), a column
        conversion under "numpy".

        ``block_format`` must be bound ON THE DRIVER (dataset
        construction time) when the conversion happens inside a spawned
        read task — worker processes are fresh interpreters whose
        DataContext is the default, so consulting it there would
        silently produce numpy blocks."""
        if block_format is None:
            from .context import DataContext
            block_format = DataContext.get().block_format
        if block_format == "arrow":
            return table
        return {name: np.asarray(col)
                for name, col in zip(table.column_names, table.columns)}

    def to_arrow(self):
        if self._arrow:
            return self._b
        import pyarrow as pa
        return pa.table({k: v for k, v in self._b.items()})

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """Column dict of ndarrays — the device-feed boundary; the only
        place an Arrow pipeline materializes numpy."""
        if not self._arrow:
            return self._b
        return {name: np.asarray(col) for name, col in
                zip(self._b.column_names, self._b.columns)}

    def to_pandas(self):
        if self._arrow:
            return self._b.to_pandas()
        import pandas as pd
        return pd.DataFrame({k: list(v) if v.ndim > 1 else v
                             for k, v in self._b.items()})

    def num_rows(self) -> int:
        if self._arrow:
            return self._b.num_rows
        if not self._b:
            return 0
        return len(next(iter(self._b.values())))

    def size_bytes(self) -> int:
        if self._arrow:
            return self._b.nbytes
        return sum(v.nbytes for v in self._b.values())

    def slice(self, start: int, end: int) -> Block:
        if self._arrow:
            return self._b.slice(start, end - start)   # zero-copy view
        return {k: v[start:end] for k, v in self._b.items()}

    def take(self, indices: np.ndarray) -> Block:
        if self._arrow:
            return self._b.take(indices)
        return {k: v[indices] for k, v in self._b.items()}

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        if self._arrow:
            for row in self._b.to_pylist():
                yield row
            return
        n = self.num_rows()
        for i in range(n):
            yield {k: v[i] for k, v in self._b.items()}

    def schema(self) -> Dict[str, str]:
        if self._arrow:
            return {f.name: str(f.type) for f in self._b.schema}
        return {k: str(v.dtype) for k, v in self._b.items()}

    @staticmethod
    def concat(blocks: List[Block]) -> Block:
        blocks = [b for b in blocks
                  if b is not None and BlockAccessor(b).num_rows() > 0]
        if not blocks:
            return {}
        if _is_arrow(blocks[0]):
            import pyarrow as pa
            return pa.concat_tables(blocks)            # zero-copy chunks
        keys = blocks[0].keys()
        return {k: np.concatenate([b[k] for b in blocks]) for k in keys}
