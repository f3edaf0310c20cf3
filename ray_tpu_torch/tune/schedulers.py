"""Trial schedulers: FIFO, ASHA, median-stopping, HyperBand, PBT (a copy
of ``ray_tpu/tune/schedulers.py``).

Reference analog: python/ray/tune/schedulers/ (async_hyperband.py
ASHAScheduler, hyperband.py HyperBandScheduler, median_stopping_rule.py,
pbt.py PopulationBasedTraining).  The controller calls
``on_result(trial_id, step, value)`` for every intermediate report; CONTINUE
or STOP comes back.  PBT additionally exposes ``take_restart(trial_id)``:
after a STOP the tuner asks whether the trial should be relaunched with an
exploited config + checkpoint (the pause/exploit/explore cycle).
"""

from __future__ import annotations

import collections
import math
import random
from typing import Any, Callable, Dict, List, Optional, Tuple

CONTINUE = "CONTINUE"
STOP = "STOP"


class FIFOScheduler:
    def on_result(self, trial_id: str, step: int, value: float) -> str:
        return CONTINUE


class ASHAScheduler:
    """Asynchronous successive halving (reference: async_hyperband.py).

    Rungs at grace_period * reduction_factor**k; a trial reaching a rung
    stops unless its metric is in the top 1/reduction_factor of completed
    rung entries.
    """

    def __init__(self, metric: str = "loss", mode: str = "min",
                 grace_period: int = 1, reduction_factor: int = 3,
                 max_t: int = 100):
        self.metric = metric
        self.mode = mode
        self.grace = grace_period
        self.rf = reduction_factor
        self.max_t = max_t
        self._rungs: Dict[int, List[float]] = collections.defaultdict(list)

    def _rung_levels(self) -> List[int]:
        levels = []
        t = self.grace
        while t < self.max_t:
            levels.append(t)
            t *= self.rf
        return levels

    def on_result(self, trial_id: str, step: int, value: float) -> str:
        if self.mode == "max":
            value = -value
        for rung in self._rung_levels():
            if step == rung:
                peers = self._rungs[rung]
                peers.append(value)
                k = max(1, len(peers) // self.rf)
                cutoff = sorted(peers)[k - 1]
                if value > cutoff:
                    return STOP
        return CONTINUE


class MedianStoppingRule:
    """Stop a trial whose running-best is worse than the median of other
    trials' running means (reference: median_stopping_rule.py)."""

    def __init__(self, metric: str = "loss", mode: str = "min",
                 grace_period: int = 1, min_samples_required: int = 3):
        self.metric = metric
        self.mode = mode
        self.grace = grace_period
        self.min_samples = min_samples_required
        self._history: Dict[str, List[float]] = collections.defaultdict(list)

    def on_result(self, trial_id: str, step: int, value: float) -> str:
        if self.mode == "max":
            value = -value
        self._history[trial_id].append(value)
        if step < self.grace:
            return CONTINUE
        others = [sum(v) / len(v) for t, v in self._history.items()
                  if t != trial_id and v]
        if len(others) < self.min_samples:
            return CONTINUE
        others_sorted = sorted(others)
        median = others_sorted[len(others_sorted) // 2]
        best = min(self._history[trial_id])
        return STOP if best > median else CONTINUE


class HyperBandScheduler:
    """HyperBand (reference: tune/schedulers/hyperband.py): multiple
    successive-halving brackets trading off number of configurations vs
    budget per configuration.  Trials are assigned to brackets round-robin
    at first report; within a bracket, a trial reaching its current rung
    stops unless in the top 1/eta of that rung's completed entries (the
    asynchronous rung rule, so stragglers never block a bracket)."""

    def __init__(self, metric: str = "loss", mode: str = "min",
                 max_t: int = 81, eta: int = 3):
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.eta = eta
        # Bracket k starts its first rung at eta**k steps (integer loop:
        # float log truncation would drop the final bracket for exact
        # powers of eta).
        self._brackets: List[List[int]] = []
        start = 1
        while start <= max_t:
            rungs = []
            t = start
            while t < max_t:
                rungs.append(t)
                t *= eta
            self._brackets.append(rungs or [max_t])
            start *= eta
        self._trial_bracket: Dict[str, int] = {}
        self._next_bracket = 0
        self._rungs: Dict[Tuple[int, int], List[float]] = \
            collections.defaultdict(list)

    def on_result(self, trial_id: str, step: int, value: float) -> str:
        if self.mode == "max":
            value = -value
        b = self._trial_bracket.get(trial_id)
        if b is None:
            b = self._next_bracket % len(self._brackets)
            self._next_bracket += 1
            self._trial_bracket[trial_id] = b
        for rung in self._brackets[b]:
            if step == rung:
                peers = self._rungs[(b, rung)]
                peers.append(value)
                k = max(1, len(peers) // self.eta)
                cutoff = sorted(peers)[k - 1]
                if value > cutoff:
                    return STOP
        return CONTINUE


class PopulationBasedTraining:
    """PBT (reference: tune/schedulers/pbt.py): every
    ``perturbation_interval`` steps, trials in the bottom quantile stop
    and restart from a top-quantile trial's checkpoint with mutated
    hyperparameters (exploit + explore).

    ``hyperparam_mutations``: {name: list-of-choices | callable() | (lo, hi)}.
    The tuner drives the restart: after a STOP it calls
    ``take_restart(trial_id)`` and, when a directive comes back, relaunches
    the trial with the new config seeded from the source checkpoint.
    """

    def __init__(self, metric: str = "loss", mode: str = "min",
                 perturbation_interval: int = 4,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 seed: int = 0):
        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.resample_p = resample_probability
        self._rng = random.Random(seed)
        self._latest: Dict[str, float] = {}
        self._configs: Dict[str, Dict[str, Any]] = {}
        self._restarts: Dict[str, Tuple[Dict[str, Any], str]] = {}

    def register_trial(self, trial_id: str, config: Dict[str, Any]) -> None:
        self._configs[trial_id] = dict(config)

    def _mutate(self, config: Dict[str, Any]) -> Dict[str, Any]:
        out = dict(config)
        for name, spec in self.mutations.items():
            if self._rng.random() < self.resample_p or name not in out:
                out[name] = self._sample(spec)
            elif isinstance(spec, list):
                # Categorical: step to an adjacent allowed value
                # (reference pbt.py behavior) — never off-menu products.
                try:
                    i = spec.index(out[name])
                    j = max(0, min(len(spec) - 1,
                                   i + self._rng.choice([-1, 1])))
                    out[name] = spec[j]
                except ValueError:
                    out[name] = self._sample(spec)
            elif isinstance(out[name], (int, float)):
                factor = self._rng.choice([0.8, 1.2])
                v = out[name] * factor
                if isinstance(out[name], int):
                    v = max(int(v), 1) if out[name] >= 1 else int(v)
                out[name] = type(out[name])(v)
            else:
                out[name] = self._sample(spec)
        return out

    def _sample(self, spec):
        """callable -> call it; 2-number tuple -> uniform range;
        list/other iterable -> categorical choice."""
        if callable(spec):
            return spec()
        if isinstance(spec, tuple) and len(spec) == 2 and all(
                isinstance(x, (int, float)) for x in spec):
            lo, hi = spec
            return self._rng.uniform(lo, hi)
        return self._rng.choice(list(spec))

    def on_result(self, trial_id: str, step: int, value: float) -> str:
        signed = -value if self.mode == "max" else value
        self._latest[trial_id] = signed
        if step % self.interval != 0 or len(self._latest) < 2:
            return CONTINUE
        ordered = sorted(self._latest.items(), key=lambda kv: kv[1])
        n = len(ordered)
        k = max(1, int(n * self.quantile))
        top = [t for t, _ in ordered[:k]]
        bottom = {t for t, _ in ordered[-k:]}
        if trial_id in bottom and trial_id not in top:
            source = self._rng.choice(top)
            new_config = self._mutate(self._configs.get(source, {}))
            self._restarts[trial_id] = (new_config, source)
            return STOP
        return CONTINUE

    def take_restart(self, trial_id: str
                     ) -> Optional[Tuple[Dict[str, Any], str]]:
        """(new_config, source_trial_id) when this STOP was an exploit."""
        return self._restarts.pop(trial_id, None)
