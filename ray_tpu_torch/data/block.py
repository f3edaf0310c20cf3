"""Blocks: the unit of data (a copy of the numpy half of
ray_tpu/data/block.py).  A block is a column dict of numpy arrays; the
Arrow layout, and the Dataset and executor that produce blocks, are not
ported (ROADMAP Queue 1 item 3(c), "data pipeline")."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

Block = Dict[str, np.ndarray]


class BlockAccessor:
    def __init__(self, block: Block):
        if not isinstance(block, dict):
            raise TypeError(f"a block is a dict of numpy arrays, not "
                            f"{type(block).__name__} (the Arrow layout is "
                            "not ported)")
        self._b = block

    def to_numpy(self) -> Dict[str, np.ndarray]:
        return self._b

    def num_rows(self) -> int:
        if not self._b:
            return 0
        return len(next(iter(self._b.values())))

    def slice(self, start: int, end: int) -> Block:
        return {k: v[start:end] for k, v in self._b.items()}

    def take(self, indices: np.ndarray) -> Block:
        return {k: v[indices] for k, v in self._b.items()}

    @staticmethod
    def concat(blocks: List[Block]) -> Block:
        blocks = [b for b in blocks
                  if b is not None and BlockAccessor(b).num_rows() > 0]
        if not blocks:
            return {}
        return {k: np.concatenate([b[k] for b in blocks])
                for k in blocks[0].keys()}
