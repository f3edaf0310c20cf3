"""Metrics time-series store: bounded per-series rings with windowed queries
(a copy of ray_tpu/metricsview/store.py's ``SeriesStore``, the part the
fleet autoscaler embeds).

* **One ring per (series, tag-set)**: ``deque(maxlen=max_points)`` of
  fixed-interval downsampled points; a new sample landing in the same
  ``interval_s`` bucket as the ring's tail *replaces* it, so a burst of
  appends costs one point and retention is ``interval_s * max_points``
  seconds regardless of push rate.
* **Counters stay raw monotonic**: ``rate``/``delta`` reconstruct
  increases at query time (reset-aware, like PromQL ``increase``).
* **Histograms stay cumulative bucket vectors**: each point carries the
  full cumulative bucket counts + sum + count, so the delta between any two
  points reconstructs the window's observation distribution and therefore
  window percentiles.

Timestamps are ``time.monotonic()`` domain (callers may feed a logical
clock in tests); queries report relative to *now*.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from .query import HistPoint, ScalarPoint, aggregate_window, combine_results


def _tags_key(tags: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in tags.items()))


class _Series:
    __slots__ = ("name", "tags", "mtype", "bounds", "points")

    def __init__(self, name: str, tags: Dict[str, str], mtype: str,
                 bounds: Optional[List[float]], max_points: int):
        self.name = name
        self.tags = dict(tags)
        self.mtype = mtype            # counter | gauge | histogram
        self.bounds = bounds          # finite boundaries (histogram only)
        self.points: deque = deque(maxlen=max_points)


class SeriesStore:
    """Bounded multi-series time-series store with windowed queries."""

    def __init__(self, interval_s: float = 1.0, max_points: int = 600,
                 max_series: int = 2048):
        self.interval_s = max(1e-9, float(interval_s))
        self.max_points = int(max_points)
        self.max_series = int(max_series)
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, Tuple], _Series] = {}

    def append(self, name: str, tags: Dict[str, str], mtype: str,
               value: Any, now: float,
               bounds: Optional[List[float]] = None) -> None:
        """Record one sample.  ``value`` is a float for counter/gauge; for
        histograms a dict ``{"counts": cumulative-with-+Inf, "sum",
        "count"}`` (``bounds`` gives the finite boundaries, stored once)."""
        with self._lock:
            key = (name, _tags_key(tags))
            series = self._series.get(key)
            if series is None:
                if len(self._series) >= self.max_series:
                    return  # over max_series: dropped
                series = _Series(name, tags, mtype, bounds, self.max_points)
                self._series[key] = series
            if mtype == "histogram":
                point = HistPoint(now, tuple(value.get("counts") or ()),
                                  float(value.get("sum", 0.0)),
                                  int(value.get("count", 0)))
                if series.bounds is None and bounds is not None:
                    series.bounds = list(bounds)
            else:
                point = ScalarPoint(now, float(value))
            ring = series.points
            if ring and int(ring[-1].t // self.interval_s) == \
                    int(now // self.interval_s):
                ring[-1] = point  # same downsample bucket: keep latest
            else:
                ring.append(point)

    def _matches(self, name: str, tags: Optional[Dict[str, str]]
                 ) -> List[_Series]:
        want = {(str(k), str(v)) for k, v in (tags or {}).items()}
        out = []
        for (sname, _tk), series in self._series.items():
            if sname != name:
                continue
            if want and not want.issubset(set(series.tags.items())):
                continue
            out.append(series)
        return out

    def query(self, name: str, window_s: float = 60.0, agg: str = "avg",
              tags: Optional[Dict[str, str]] = None,
              now: Optional[float] = None) -> Dict[str, Any]:
        """Windowed aggregate over matching series.  ``agg`` is one of
        ``rate | delta | avg | min | max | last | pNN`` (``pNN`` needs a
        histogram series).  Returns ``{"name", "agg", "window_s", "tags",
        "value", "series", "points"}``; ``value`` is None when no data lands
        in the window (or the agg is unsupported for the type)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            matched = self._matches(name, tags)
            per_series = [aggregate_window(s.points, s.mtype, s.bounds,
                                           now - float(window_s), now, agg)
                          for s in matched]
            mtypes = {s.mtype for s in matched}
        value, npoints = combine_results(
            per_series, agg, mtypes.pop() if len(mtypes) == 1 else "gauge")
        return {"name": name, "agg": agg, "window_s": float(window_s),
                "tags": dict(tags or {}), "value": value,
                "series": len(matched), "points": npoints}
