"""Execution context for the Data library (a copy of
ray_tpu/data/context.py; reference: python/ray/data/context.py
DataContext — global execution knobs).

``op_memory_budget_bytes`` drives per-operator backpressure: each
streaming stage sizes its in-flight window from the budget divided by the
operator's OBSERVED average block size (EMA), clamped to
[min_in_flight, max_in_flight] — small blocks pipeline deep, huge blocks
throttle to a couple in flight (reference:
_internal/execution/backpressure_policy/ concurrency caps +
reservation-based memory scheduling).
"""

from __future__ import annotations

from typing import Optional


class DataContext:
    _instance: Optional["DataContext"] = None

    def __init__(self):
        self.op_memory_budget_bytes: int = 256 << 20
        self.min_in_flight: int = 2
        self.max_in_flight: int = 32
        # Window used before any block size has been observed.
        self.initial_in_flight: int = 8
        # Whether streaming iteration yields blocks in plan order.  False
        # (the reference's ExecutionOptions.preserve_order default) lets
        # iter_batches surface whichever block finishes first, so one slow
        # task never head-of-line-blocks the consumer.  take()/execute()
        # always preserve order regardless.
        self.preserve_order: bool = False
        # Physical block layout: "numpy" (dict of ndarrays — the
        # device-feed default) or "arrow" (pyarrow Tables: parquet scans
        # and slice/take/concat stay zero-copy; numpy materializes only
        # at the consumer boundary).  Reference:
        # _internal/arrow_block.py Arrow-native blocks.
        self.block_format: str = "numpy"

    @classmethod
    def get(cls) -> "DataContext":
        if cls._instance is None:
            cls._instance = DataContext()
        return cls._instance
