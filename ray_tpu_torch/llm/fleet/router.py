"""Prefix-affinity replica selection for the decode fleet (a copy of
ray_tpu/llm/fleet/router.py).

Reference analog: prefix-aware request routing in SGLang's router and
the reference's serve request-router plugins — requests sharing a
prompt prefix should land on the replica that already holds that
prefix's KV, UNLESS that replica is overloaded, in which case load wins
(cache affinity is a latency optimization, not a correctness
constraint, and herding every hot-prefix request onto one replica
recreates the head-of-line blocking the fleet exists to remove).

Pure decision logic over published snapshots: the router never touches
an engine — it scores each replica's prefix-index digest
(:func:`~ray_tpu_torch.llm.fleet.prefix.score_summary`) against the request's
block chain and picks by (full hit > longest shared prefix > least
loaded), with an imbalance watermark that overrides affinity when the
favored replica's depth exceeds the fleet minimum by too much.
Telemetry is the caller's job; this module stays import-light and
unit-testable with dict fixtures.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

from .prefix import score_summary


@dataclass
class RoutingConfig:
    #: Affinity holds only while the favored replica's depth (ongoing +
    #: assigned-but-not-imported) is within this many requests of the
    #: least-loaded candidate; beyond it the request re-balances.
    imbalance_watermark: int = 8
    #: Minimum shared blocks for PARTIAL affinity to influence routing
    #: (full hits always qualify).  One block of overlap on a long
    #: prompt is noise, not affinity.
    min_shared_blocks: int = 1


@dataclass
class RouteDecision:
    replica: str
    #: "full" (exact prompt cached — prefill skippable), "partial"
    #: (prefix overlap steered routing), "miss" (load-only placement).
    outcome: str
    #: Affinity named a different replica but the watermark overrode it.
    rebalanced: bool = False
    shared_blocks: int = 0


def _depth(view: Dict[str, Any]) -> int:
    load = view.get("load") or {}
    return int(load.get("ongoing", 0)) + int(view.get("assigned", 0))


class FleetRouter:
    """Scores replica snapshots; owns no state but its config."""

    def __init__(self, config: Optional[RoutingConfig] = None):
        self.config = config or RoutingConfig()

    def route(self, replicas: List[Dict[str, Any]], chain: Sequence[str],
              fh: str) -> Optional[RouteDecision]:
        """Pick a replica for one admitted request.

        ``replicas``: one view per candidate —
        ``{"name", "load": load_stats(), "summary": summary(),
        "assigned": int}``.  Non-accepting replicas must already be
        filtered out by the caller.  Returns None when the list is
        empty (caller sheds)."""
        if not replicas:
            return None
        cfg = self.config
        scored = []
        for view in replicas:
            full, shared = score_summary(view.get("summary"), chain, fh)
            scored.append((view["name"], full, shared, _depth(view)))
        min_depth = min(d for _n, _f, _s, d in scored)

        def overloaded(depth: int) -> bool:
            return depth - min_depth > cfg.imbalance_watermark

        # Full hits first: prefill is skippable there, the biggest win.
        fulls = [s for s in scored if s[1]]
        if fulls:
            name, _f, shared, depth = min(fulls, key=lambda s: s[3])
            if not overloaded(depth):
                return RouteDecision(name, "full", shared_blocks=shared)
            return self._rebalance(scored, "full", shared)
        partials = [s for s in scored
                    if s[2] >= max(1, cfg.min_shared_blocks)]
        if partials:
            name, _f, shared, depth = max(
                partials, key=lambda s: (s[2], -s[3]))
            if not overloaded(depth):
                return RouteDecision(name, "partial",
                                     shared_blocks=shared)
            return self._rebalance(scored, "partial", shared)
        name, _f, shared, _d = min(scored, key=lambda s: s[3])
        return RouteDecision(name, "miss", shared_blocks=shared)

    @staticmethod
    def _rebalance(scored, would_be: str, shared: int) -> RouteDecision:
        """Watermark override: place by load alone.  The outcome
        reports what the request actually gets on the chosen replica —
        a rebalanced full-hit still lands as a miss unless the
        least-loaded replica happens to hold the prompt too."""
        name, full, shared_here, _d = min(scored, key=lambda s: s[3])
        outcome = "full" if full else "miss"
        return RouteDecision(name, outcome, rebalanced=True,
                             shared_blocks=shared_here)
