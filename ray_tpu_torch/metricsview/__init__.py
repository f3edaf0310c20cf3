"""ray_tpu_torch.metricsview: the bounded time-series store and its
windowed queries (counterpart of ray_tpu/metricsview; the head's
``MetricsView`` and SLO engine need the cluster runtime and are not
ported)."""

from .store import SeriesStore

__all__ = ["SeriesStore"]
