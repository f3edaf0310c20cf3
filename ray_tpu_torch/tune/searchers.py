"""Adaptive search algorithms: Searcher ABC, TPE, limiter/repeater wrappers
(a copy of ``ray_tpu/tune/searchers.py``).

Reference analog: python/ray/tune/search/ — Searcher (searcher.py),
ConcurrencyLimiter (search_generator/concurrency limiting), Repeater
(repeater.py), and the external-library searchers (optuna/hyperopt/bohb).
The external deps aren't available here, so the model-based searcher is a
self-contained pure-numpy TPE (Bergstra et al. 2011, the algorithm behind
hyperopt/optuna defaults): split observations into good/bad quantiles,
model each with a kernel density, and suggest the candidate maximizing the
good/bad density ratio.  Combine ``TPESearcher`` with the HyperBand
scheduler for BOHB-style behavior (model-based sampling + bracketed early
stopping).
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .search import Choice, GridSearch, LogUniform, RandInt, Uniform


class Searcher:
    """Suggest/observe interface (reference: tune/search/searcher.py).

    ``suggest(trial_id)`` returns a config dict (or None when the searcher
    has nothing to offer right now); ``on_trial_complete(trial_id, score)``
    feeds the final metric back.  ``mode`` normalization (min/max) is the
    Tuner's job: searchers always MINIMIZE the reported score.
    """

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str,
                          score: Optional[float]) -> None:
        pass


class BasicVariantSearcher(Searcher):
    """Random/grid sampling as a Searcher (reference:
    BasicVariantGenerator)."""

    def __init__(self, param_space: Dict[str, Any], num_samples: int = 1,
                 seed: int = 0):
        from .search import generate_variants
        self._variants = generate_variants(param_space, num_samples, seed)
        self._next = 0

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._next >= len(self._variants):
            return None
        cfg = self._variants[self._next]
        self._next += 1
        return cfg


class TPESearcher(Searcher):
    """Tree-structured Parzen Estimator over the tune search space.

    Supports Uniform / LogUniform / RandInt / Choice dimensions (grid axes
    are static by nature — use BasicVariantSearcher for those).  Constants
    pass through unchanged.
    """

    def __init__(self, param_space: Dict[str, Any], *,
                 n_startup_trials: int = 10, gamma: float = 0.25,
                 n_candidates: int = 24, epsilon: float = 0.15,
                 seed: int = 0):
        for k, v in param_space.items():
            if isinstance(v, GridSearch):
                raise ValueError(
                    f"TPESearcher does not support grid_search ({k!r}); "
                    "use BasicVariantSearcher or expand the grid manually")
        self.space = param_space
        self.n_startup = n_startup_trials
        self.gamma = gamma
        self.n_candidates = n_candidates
        # Fraction of model-phase suggestions drawn uniformly at random:
        # the density-ratio argmax alone cannot leave an established
        # cluster (distant candidates always lose on g-density), so a
        # random restart share is what finds better basins.
        self.epsilon = epsilon
        self._rng = random.Random(seed)
        self._np_rng = np.random.default_rng(seed)
        self._pending: Dict[str, Dict[str, Any]] = {}
        self._obs: List[Tuple[Dict[str, Any], float]] = []

    # -- space helpers ------------------------------------------------------

    def _sample_random(self) -> Dict[str, Any]:
        cfg = {}
        for k, v in self.space.items():
            if isinstance(v, (Choice, Uniform, LogUniform, RandInt)):
                cfg[k] = v.sample(self._rng)
            else:
                cfg[k] = v
        return cfg

    @staticmethod
    def _to_unit(dim, value) -> Optional[float]:
        """Map a numeric dimension's value into continuous model space."""
        if isinstance(dim, Uniform):
            return float(value)
        if isinstance(dim, LogUniform):
            return math.log(float(value))
        if isinstance(dim, RandInt):
            return float(value)
        return None

    @staticmethod
    def _from_unit(dim, x: float):
        if isinstance(dim, Uniform):
            return float(np.clip(x, dim.low, dim.high))
        if isinstance(dim, LogUniform):
            return float(np.clip(math.exp(x), dim.low, dim.high))
        if isinstance(dim, RandInt):
            return int(np.clip(round(x), dim.low, dim.high - 1))
        return x

    # -- TPE core ------------------------------------------------------------

    @staticmethod
    def _adaptive_bw(samples: np.ndarray, span: float) -> np.ndarray:
        """Per-kernel bandwidths from neighbor gaps (the adaptive-Parzen
        heuristic hyperopt uses): isolated points get wide kernels that
        spread mass across unexplored territory; clustered points get
        narrow ones.  Clipped to [2%, 100%] of the dimension span."""
        n = len(samples)
        if n == 1:
            return np.array([span / 2.0])
        order = np.argsort(samples)
        s = samples[order]
        gaps = np.empty(n)
        gaps[0] = s[1] - s[0]
        gaps[-1] = s[-1] - s[-2]
        if n > 2:
            gaps[1:-1] = np.maximum(s[2:] - s[1:-1], s[1:-1] - s[:-2])
        bw_sorted = np.clip(gaps, span * 0.02, span)
        bw = np.empty(n)
        bw[order] = bw_sorted
        return bw

    @staticmethod
    def _kde_logpdf(samples: np.ndarray, bw: np.ndarray,
                    xs: np.ndarray) -> np.ndarray:
        """Mixture-of-Gaussians log-density with per-kernel bandwidths."""
        d = (xs[:, None] - samples[None, :]) / bw[None, :]
        logk = -0.5 * d * d - np.log(bw[None, :] *
                                     math.sqrt(2 * math.pi))
        m = logk.max(axis=1)
        return m + np.log(np.exp(logk - m[:, None]).sum(axis=1) + 1e-300) \
            - math.log(len(samples))

    def _suggest_model(self) -> Dict[str, Any]:
        scores = np.array([s for _, s in self._obs])
        order = np.argsort(scores)  # minimize
        n_good = max(1, int(math.ceil(self.gamma * len(self._obs))))
        good_idx = set(order[:n_good].tolist())
        good = [self._obs[i][0] for i in range(len(self._obs))
                if i in good_idx]
        bad = [self._obs[i][0] for i in range(len(self._obs))
               if i not in good_idx] or good
        cfg: Dict[str, Any] = {}
        for k, dim in self.space.items():
            if isinstance(dim, Choice):
                # Category ratio with +1 smoothing.
                counts_g = {v: 1.0 for v in range(len(dim.values))}
                counts_b = {v: 1.0 for v in range(len(dim.values))}
                for c in good:
                    counts_g[dim.values.index(c[k])] += 1
                for c in bad:
                    counts_b[dim.values.index(c[k])] += 1
                ratio = {i: counts_g[i] / counts_b[i]
                         for i in range(len(dim.values))}
                best = max(ratio, key=ratio.get)
                cfg[k] = dim.values[best]
            elif isinstance(dim, (Uniform, LogUniform, RandInt)):
                g = np.array([self._to_unit(dim, c[k]) for c in good])
                b = np.array([self._to_unit(dim, c[k]) for c in bad])
                if isinstance(dim, LogUniform):
                    lo, hi = math.log(dim.low), math.log(dim.high)
                else:
                    lo, hi = float(dim.low), float(dim.high)
                span = hi - lo
                g_bw = self._adaptive_bw(g, span)
                b_bw = self._adaptive_bw(b, span)
                # Candidates: kernel draws from the good KDE plus a
                # uniform-prior share (hyperopt mixes a uniform prior into
                # l(x) so unexplored territory keeps nonzero density).
                n_kde = max(1, (3 * self.n_candidates) // 4)
                n_uni = self.n_candidates - n_kde
                picks = self._np_rng.choice(len(g), n_kde)
                cand = np.concatenate([
                    g[picks] + self._np_rng.normal(0, 1, n_kde) *
                    g_bw[picks],
                    self._np_rng.uniform(lo, hi, n_uni)])
                cand = np.clip(cand, lo, hi)
                # Uniform-prior mixing (weight ~1 virtual point) keeps the
                # ratio finite far from both sets.
                prior = -math.log(span)
                lg = np.logaddexp(self._kde_logpdf(g, g_bw, cand),
                                  prior - math.log(len(g) + 1))
                lb = np.logaddexp(self._kde_logpdf(b, b_bw, cand),
                                  prior - math.log(len(b) + 1))
                cfg[k] = self._from_unit(dim, float(cand[np.argmax(lg - lb)]))
            else:
                cfg[k] = dim
        return cfg

    # -- Searcher interface ---------------------------------------------------

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if len(self._obs) < self.n_startup or \
                self._rng.random() < self.epsilon:
            cfg = self._sample_random()
        else:
            cfg = self._suggest_model()
        self._pending[trial_id] = cfg
        return cfg

    def on_trial_complete(self, trial_id: str,
                          score: Optional[float]) -> None:
        cfg = self._pending.pop(trial_id, None)
        if cfg is not None and score is not None and math.isfinite(score):
            self._obs.append((cfg, float(score)))


class ConcurrencyLimiter(Searcher):
    """Cap outstanding suggestions (reference:
    tune/search/concurrency_limiter.py) — essential for model-based
    searchers whose quality depends on completed observations."""

    def __init__(self, searcher: Searcher, max_concurrent: int):
        if max_concurrent < 1:
            raise ValueError("max_concurrent must be >= 1")
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self._live: set = set()

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if len(self._live) >= self.max_concurrent:
            return None
        cfg = self.searcher.suggest(trial_id)
        if cfg is not None:
            self._live.add(trial_id)
        return cfg

    def on_trial_complete(self, trial_id: str,
                          score: Optional[float]) -> None:
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, score)


class Repeater(Searcher):
    """Repeat each underlying suggestion N times and report the mean back
    (reference: tune/search/repeater.py — noise-robust evaluation)."""

    def __init__(self, searcher: Searcher, repeat: int):
        if repeat < 1:
            raise ValueError("repeat must be >= 1")
        self.searcher = searcher
        self.repeat = repeat
        self._groups: Dict[str, Dict[str, Any]] = {}
        self._trial_group: Dict[str, str] = {}
        self._counter = 0

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        # Find a group that still needs repeats.
        for gid, g in self._groups.items():
            if g["launched"] < self.repeat:
                g["launched"] += 1
                self._trial_group[trial_id] = gid
                return dict(g["config"])
        gid = f"group-{self._counter}"
        self._counter += 1
        cfg = self.searcher.suggest(gid)
        if cfg is None:
            return None
        self._groups[gid] = {"config": cfg, "launched": 1, "completed": 0,
                             "scores": []}
        self._trial_group[trial_id] = gid
        return dict(cfg)

    def on_trial_complete(self, trial_id: str,
                          score: Optional[float]) -> None:
        gid = self._trial_group.pop(trial_id, None)
        if gid is None:
            return
        g = self._groups[gid]
        g["completed"] += 1
        if score is not None:
            g["scores"].append(score)
        if g["completed"] >= self.repeat:
            mean = float(np.mean(g["scores"])) if g["scores"] else None
            self.searcher.on_trial_complete(gid, mean)
            del self._groups[gid]
