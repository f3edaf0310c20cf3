"""Scaling policies: how large the next worker group should be (a copy of
``ray_tpu/train/scaling_policy.py``; a worker of the port holds one card,
or one CPU with ``ScalingConfig(device="cpu")``).

Reference: python/ray/train/v2/_internal/execution/scaling_policy/
(fixed.py, elastic.py) — the controller consults the policy before every
group (re)start and between status polls; an elastic decision triggers
group teardown + re-formation + checkpoint restore (JAX cannot resize a
live mesh, so resize == restart, same as the reference's torch elastic).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, Optional


def default_worker_resources(scaling_config) -> Dict[str, float]:
    """What one worker books when ``resources_per_worker`` is unset: a
    card (``ScalingConfig(device=None)``), or one CPU for a CPU worker."""
    if scaling_config.device == "cpu":
        return {"CPU": 1.0}
    return {"GPU": 1.0}


@dataclass
class ScalingDecision:
    num_workers: int
    reason: str = ""


class FixedScalingPolicy:
    def __init__(self, scaling_config):
        self.scaling = scaling_config

    def initial_decision(self, prefer: Optional[int] = None
                         ) -> ScalingDecision:
        return ScalingDecision(self.scaling.num_workers, "fixed")

    def monitor_decision(self, current: int) -> Optional[ScalingDecision]:
        return None  # never resizes mid-run


class ElasticScalingPolicy:
    """Size groups to current cluster capacity in [min, max] workers,
    snapped down to a world size the MeshConfig can tile (a group the
    mesh cannot factor must never form — resizing to it would only die
    in mesh construction and burn failure budget)."""

    def __init__(self, scaling_config, node):
        self.scaling = scaling_config
        #: The scheduler node the workers book on (``_scheduler.Node``).
        self.node = node
        self.mesh = getattr(scaling_config, "mesh_config", None)
        self.min = scaling_config.min_workers or 1
        self.max = scaling_config.max_workers or max(
            scaling_config.num_workers, self.min)
        if self.min > self.max:
            raise ValueError(
                f"min_workers ({self.min}) > max_workers ({self.max})")

    def _snap(self, n: int) -> int:
        """Largest mesh-tileable world size <= n (0 when none is)."""
        if self.mesh is None or n <= 0:
            return n
        v = self.mesh.nearest_valid_world(
            n, floor=1, num_slices=self.scaling.num_slices)
        return v if v is not None else 0

    def _per_worker_resources(self) -> Dict[str, float]:
        res = dict(self.scaling.resources_per_worker or {})
        if not res:
            res = default_worker_resources(self.scaling)
        return res

    def _fit_count(self) -> int:
        avail = self.node.available_resources()
        per = self._per_worker_resources()
        fit = math.inf
        for name, amount in per.items():
            if amount <= 0:
                continue
            fit = min(fit, int(avail.get(name, 0.0) // amount))
        if fit is math.inf:
            fit = self.max
        return self._snap(max(min(int(fit), self.max), 0))

    def initial_decision(self, timeout_s: float = 120.0,
                         prefer: Optional[int] = None) -> ScalingDecision:
        """Wait until at least min_workers fit, then take all that fit.

        ``prefer`` carries a monitor decision across the restart: right
        after a teardown the old group's resources release asynchronously,
        so the policy briefly waits for capacity to reach the preferred
        size before settling for whatever fits."""
        deadline = time.monotonic() + timeout_s
        prefer_deadline = time.monotonic() + 10.0 if prefer else None
        prefer_target = self._snap(min(prefer, self.max)) \
            if prefer is not None else None
        while True:
            fit = self._fit_count()
            if prefer_target is not None and fit >= prefer_target > 0:
                # Capacity beyond the preferred size is taken NOW (fit
                # is already snapped and max-clamped): when a pre-bought
                # replacement joined during the drain, the post-drain
                # reform upsizes back in one formation instead of
                # limping at n-1 and paying a second teardown once the
                # monitor notices.
                return ScalingDecision(fit, f"resized to {fit}")
            if fit >= self.min and (
                    prefer_deadline is None
                    or time.monotonic() > prefer_deadline):
                return ScalingDecision(fit, f"capacity fits {fit}")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"elastic trainer needs >= {self.min} workers; cluster "
                    f"fits only {fit}")
            time.sleep(0.5)

    def monitor_decision(self, current: int) -> Optional[ScalingDecision]:
        """Upsize when new capacity appears — the reaction to an elastic
        add_node or a pre-bought replacement joining (downsizing happens
        naturally through the drain/failure paths when nodes die).  The
        target is the nearest mesh-tileable world >= current that the
        joined capacity fits: growth the mesh cannot use is not worth a
        teardown + restore, and the controller only acts on the decision
        at a checkpoint boundary so the reform replays ~0 steps."""
        headroom = self._fit_count()
        target = self._snap(min(current + headroom, self.max))
        if target > current:
            return ScalingDecision(
                target, f"capacity grew: {current} -> {target}")
        return None


def make_scaling_policy(scaling_config, node):
    if scaling_config.elastic:
        return ElasticScalingPolicy(scaling_config, node)
    return FixedScalingPolicy(scaling_config)
