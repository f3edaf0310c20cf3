"""Utility layer of the port (counterpart of ray_tpu/util): actor pools, the
distributed queue, user metrics (``metrics``), tracing, the train and
serving paths' telemetry, and the card helpers (``gpu``).

Reference analogs: python/ray/util/actor_pool.py, util/queue.py,
util/metrics.py.
"""

from __future__ import annotations

from .actor_pool import ActorPool
from .queue import Empty, Full, Queue

__all__ = ["ActorPool", "Queue", "Empty", "Full"]
