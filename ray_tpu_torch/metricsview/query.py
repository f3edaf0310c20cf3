"""Windowed aggregation over stored points (the query half of the store; a
copy of ray_tpu/metricsview/query.py without the sparkline rows).

Semantics follow PromQL where it has an opinion:

* ``delta``/``rate`` on counters are **reset-aware**: the increase is
  measured from the *last reset* inside the window (a restarted process
  re-counts from zero; its stale prefix must not produce a negative or
  phantom-huge delta).  On gauges they are the plain signed first-to-
  last difference.
* ``pNN`` reconstructs the window's observation distribution from the
  cumulative-bucket delta between the window's endpoints, then linearly
  interpolates inside the owning bucket (PromQL ``histogram_quantile``).
* The last point *before* the window start serves as the delta baseline
  (like PromQL range vectors extending one sample left), so a 60 s
  window over a 10 s-interval series still sees a full-width delta.

Multi-series combination (a tag filter matching several tag-sets):
counter-like values (``delta``/``rate``/counter ``last``) **sum** across
series — they are cluster totals; everything else takes the mean (or
min/max for those aggs).  ``pNN`` sums the per-series bucket deltas
first and computes one quantile over the merged distribution.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

_QUANTILE_RE = re.compile(r"^p(\d{1,2}(?:\.\d+)?)$")


class ScalarPoint(NamedTuple):
    t: float
    v: float


class HistPoint(NamedTuple):
    t: float
    counts: Tuple[float, ...]  # cumulative per-bucket, +Inf last
    sum: float
    count: int


def parse_quantile(agg: str) -> Optional[float]:
    """``"p99"`` -> 0.99, ``"p99.9"`` -> 0.999; None for plain aggs."""
    m = _QUANTILE_RE.match(agg or "")
    if not m:
        return None
    q = float(m.group(1)) / 100.0
    return q if 0.0 < q < 1.0 else None


def _window(points: Sequence, start: float, end: float):
    """(baseline point before start or None, in-window points)."""
    base = None
    win: List = []
    for p in points:
        if p.t < start:
            base = p
        elif p.t <= end:
            win.append(p)
    return base, win


def _hist_quantile(q: float, bounds: Sequence[float],
                   per_bucket: Sequence[float]) -> Optional[float]:
    total = sum(per_bucket)
    if total <= 0:
        return None
    target = q * total
    cum = 0.0
    for i, n in enumerate(per_bucket):
        if n <= 0:
            continue
        if cum + n >= target:
            if i >= len(bounds):      # +Inf bucket: clamp to last bound
                return float(bounds[-1]) if bounds else None
            lo = float(bounds[i - 1]) if i > 0 else 0.0
            hi = float(bounds[i])
            return lo + (hi - lo) * ((target - cum) / n)
        cum += n
    return float(bounds[-1]) if bounds else None


def hist_window_delta(base: Optional[HistPoint], win: Sequence[HistPoint]
                      ) -> Tuple[Tuple[float, ...], float, int]:
    """Window delta with baseline fallback: prefer the last point before
    the window; else the first in-window point (PromQL ``increase``
    loses pre-first-sample counts the same way); a lone point with no
    baseline exports its full cumulative state."""
    eff = base if base is not None else (win[0] if len(win) > 1 else None)
    return _hist_window_delta(eff, win[-1])


def _hist_window_delta(base: Optional[HistPoint], last: HistPoint
                       ) -> Tuple[Tuple[float, ...], float, int]:
    """Cumulative-vector delta (counts, sum, count) across the window; a
    shrunk count means the source process restarted, so the window
    restarts at zero too (the post-restart cumulative IS the delta)."""
    if base is None or not base.counts or \
            len(base.counts) != len(last.counts):
        return last.counts, last.sum, last.count
    if last.count < base.count or \
            any(l < b for l, b in zip(last.counts, base.counts)):
        return last.counts, last.sum, last.count
    return (tuple(l - b for l, b in zip(last.counts, base.counts)),
            last.sum - base.sum, last.count - base.count)


def _scalar_delta(seq: List[ScalarPoint], counter: bool
                  ) -> Tuple[Optional[float], Optional[float]]:
    """(delta, span_s) over the point sequence; counter deltas measure
    from the last reset (value drop) so a restart yields 0, not a
    negative."""
    if len(seq) < 2:
        return None, None
    first = seq[0]
    if counter:
        for i in range(len(seq) - 1, 0, -1):
            if seq[i].v < seq[i - 1].v:
                first = seq[i]
                break
    span = seq[-1].t - first.t
    return seq[-1].v - first.v, span


def aggregate_window(points: Sequence, mtype: str,
                     bounds: Optional[Sequence[float]],
                     start: float, end: float, agg: str
                     ) -> Tuple[Optional[float], int, Optional[Tuple]]:
    """One series' windowed aggregate: ``(value, points_in_window,
    hist_delta)`` — ``hist_delta`` is ``(bounds, per_bucket)`` for
    quantile aggs so the caller can merge distributions across series
    before taking the quantile."""
    base, win = _window(points, start, end)
    if not win:
        return None, 0, None
    n = len(win)
    q = parse_quantile(agg)

    if mtype == "histogram":
        last = win[-1]
        dcounts, dsum, dcount = hist_window_delta(base, win)
        # Cumulative-in-le -> per-bucket counts for the window.
        per = [max(0.0, dcounts[i] - (dcounts[i - 1] if i else 0.0))
               for i in range(len(dcounts))]
        if q is not None:
            return (_hist_quantile(q, bounds or (), per), n,
                    (tuple(bounds or ()), tuple(per)))
        if agg == "delta":
            return float(dcount), n, None
        if agg == "rate":
            span = last.t - (base.t if base is not None else win[0].t)
            return (dcount / span if span > 0 else None), n, None
        if agg == "avg":
            return (dsum / dcount if dcount > 0 else None), n, None
        if agg == "last":
            return (last.sum / last.count if last.count else None), n, None
        return None, n, None  # min/max undefined on histograms

    values = [p.v for p in win]
    if q is not None:
        return None, n, None  # pNN needs a histogram series
    if agg == "last":
        return values[-1], n, None
    if agg == "avg":
        return sum(values) / len(values), n, None
    if agg == "min":
        return min(values), n, None
    if agg == "max":
        return max(values), n, None
    if agg in ("delta", "rate"):
        seq = ([base] if base is not None else []) + list(win)
        delta, span = _scalar_delta(seq, counter=(mtype == "counter"))
        if agg == "delta":
            return delta, n, None
        return (delta / span if delta is not None and span and span > 0
                else None), n, None
    return None, n, None


def combine_results(per_series: List[Tuple[Optional[float], int,
                                           Optional[Tuple]]],
                    agg: str, mtype: str) -> Tuple[Optional[float], int]:
    """Fold per-series windowed results into one value (see module doc
    for the sum-vs-mean rules)."""
    n = sum(r[1] for r in per_series)
    q = parse_quantile(agg)
    if q is not None:
        merged: Dict[Tuple, List[float]] = {}
        for _v, _n, hist in per_series:
            if not hist:
                continue
            bounds, per = hist
            acc = merged.setdefault(bounds, [0.0] * len(per))
            if len(acc) == len(per):
                for i, c in enumerate(per):
                    acc[i] += c
        if not merged:
            return None, n
        # Differing boundary sets can't merge; take the worst quantile.
        vals = [_hist_quantile(q, b, per) for b, per in merged.items()]
        vals = [v for v in vals if v is not None]
        return (max(vals) if vals else None), n
    values = [r[0] for r in per_series if r[0] is not None]
    if not values:
        return None, n
    summable = (mtype == "counter" and agg in ("delta", "rate", "last")) \
        or (mtype == "histogram" and agg in ("delta", "rate"))
    if summable:
        return sum(values), n
    if agg == "min":
        return min(values), n
    if agg == "max":
        return max(values), n
    return sum(values) / len(values), n
