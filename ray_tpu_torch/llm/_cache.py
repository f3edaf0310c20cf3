"""Paged KV cache: fixed page pool + per-sequence block tables (counterpart
of ray_tpu/llm/_cache.py, copied: the port imports nothing of ray_tpu).

    kv_pages    : per-layer tuple of combined [NUM_PAGES, PAGE, 2*Hkv, D]
                  tensors (K even / V odd combined-head indices — see
                  _model.decode_step)
    block table : [max_slots, pages_per_seq] int32 page ids

Page allocation is host-side (a free list in the engine); the device tensors
are updated in place.
"""

from __future__ import annotations

from typing import List, Optional


class PagePool:
    """Host-side page allocator (free list).  Page 0 is reserved as the
    null page so block tables can always point somewhere valid."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if p != 0:
                self._free.append(p)

    @property
    def num_free(self) -> int:
        return len(self._free)
