"""Connector pipelines: composable obs/action transforms on the rollout
path.

A copy of ``ray_tpu/rl/connectors.py`` (numpy only): the port imports
nothing of the JAX package, not even its framework-free modules.

Reference: rllib/connectors/ (ConnectorV2 pipelines between env and module
— env-to-module transforms observations before inference, module-to-env
transforms actions before stepping).  Connectors carry state (e.g. running
mean/std) that must ship with policy weights so remote runners and the
learner see the same preprocessing — state here is a plain dict so it
rides the same sync path as params.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np


class Connector:
    """One transform stage.  ``__call__(batch) -> batch`` where batch is a
    [N, ...] numpy array of observations (env-to-module) or actions
    (module-to-env)."""

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def transform(self, batch: np.ndarray) -> np.ndarray:
        """Apply without mutating connector state (for off-path uses like
        truncation bootstraps and evaluation).  Stateless connectors just
        delegate to __call__."""
        return self(batch)

    def on_episode_boundaries(self, done_mask: np.ndarray) -> None:
        """Notify per-sub-env episode resets BEFORE the next __call__ (whose
        batch holds the new episodes' reset observations at masked rows).
        History-keeping connectors clear those rows."""

    # Stateful connectors override these so their state syncs across
    # runners with the weights (reference: connector state in checkpoints).
    def get_state(self) -> Dict[str, Any]:
        return {}

    def set_state(self, state: Dict[str, Any]) -> None:
        pass

    def merge_states(self, states: List[Dict[str, Any]]) -> Dict[str, Any]:
        """Combine per-runner states into one canonical state (reference:
        rllib's distributed MeanStdFilter aggregation).  Default: stateless
        — nothing to merge."""
        return {}


class ConnectorPipeline(Connector):
    """Ordered list of connectors applied left-to-right (reference:
    ConnectorPipelineV2)."""

    def __init__(self, connectors: Optional[List[Connector]] = None):
        self.connectors = list(connectors or [])

    def append(self, connector: Connector) -> "ConnectorPipeline":
        self.connectors.append(connector)
        return self

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        for c in self.connectors:
            batch = c(batch)
        return batch

    def transform(self, batch: np.ndarray) -> np.ndarray:
        for c in self.connectors:
            batch = c.transform(batch)
        return batch

    def on_episode_boundaries(self, done_mask: np.ndarray) -> None:
        for c in self.connectors:
            c.on_episode_boundaries(done_mask)

    def get_state(self) -> Dict[str, Any]:
        return {str(i): c.get_state()
                for i, c in enumerate(self.connectors)}

    def set_state(self, state: Dict[str, Any]) -> None:
        for i, c in enumerate(self.connectors):
            if str(i) in state:
                c.set_state(state[str(i)])

    def merge_states(self, states: List[Dict[str, Any]]
                     ) -> Dict[str, Any]:
        return {str(i): c.merge_states([s.get(str(i), {}) for s in states])
                for i, c in enumerate(self.connectors)}

    @property
    def output_dim_factor(self) -> int:
        """How the pipeline scales the observation dim (frame-stacking
        multiplies it)."""
        f = 1
        for c in self.connectors:
            f *= getattr(c, "dim_factor", 1)
        return f


class MeanStdFilter(Connector):
    """Running mean/std observation normalization (reference: rllib's
    MeanStdFilter connector + its distributed synchronization).

    State is split into a *base* aggregate (the cluster-wide stats as of
    the last sync) and a local *delta* (samples seen since).  Sync
    protocol: the group gathers every runner's delta, merges them into the
    shared base, and broadcasts the new base back — which resets deltas.
    Merging absolute states instead would re-count the base once per
    runner per sync (n ~ runners^iterations) and freeze the stats on
    early data.  Aggregates are (n, mean, m2) Chan et al. triples with
    O(1) merges.
    """

    def __init__(self, clip: float = 10.0, update: bool = True):
        self.clip = clip
        self.update = update
        self._base: Optional[tuple] = None   # (n, mean, m2) at last sync
        self._delta: Optional[tuple] = None  # local since last sync

    @staticmethod
    def _merge_agg(a: Optional[tuple], b: Optional[tuple]
                   ) -> Optional[tuple]:
        if a is None or a[0] == 0:
            return b
        if b is None or b[0] == 0:
            return a
        na, mean_a, m2_a = a
        nb, mean_b, m2_b = b
        n = na + nb
        d = mean_b - mean_a
        mean = mean_a + d * (nb / n)
        m2 = m2_a + m2_b + d ** 2 * (na * nb / n)
        return (n, mean, m2)

    def _combined(self) -> Optional[tuple]:
        return self._merge_agg(self._base, self._delta)

    @property
    def count(self) -> int:
        agg = self._combined()
        return 0 if agg is None else int(agg[0])

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        batch = np.asarray(batch, np.float32)
        if self.update:
            rows = batch.reshape(-1, batch.shape[-1]).astype(np.float64)
            if len(rows):
                b_mean = rows.mean(axis=0)
                b_m2 = ((rows - b_mean) ** 2).sum(axis=0)
                self._delta = self._merge_agg(
                    self._delta, (len(rows), b_mean, b_m2))
        return self._normalize(batch)

    def transform(self, batch: np.ndarray) -> np.ndarray:
        return self._normalize(np.asarray(batch, np.float32))

    def _normalize(self, batch: np.ndarray) -> np.ndarray:
        agg = self._combined()
        if agg is None or agg[0] < 2:
            return np.clip(batch, -self.clip, self.clip)
        n, mean, m2 = agg
        std = np.sqrt(m2 / (n - 1)) + 1e-8
        out = (batch - mean.astype(np.float32)) / std.astype(np.float32)
        return np.clip(out, -self.clip, self.clip).astype(np.float32)

    def get_state(self) -> Dict[str, Any]:
        return {"base": self._base, "delta": self._delta}

    def set_state(self, state: Dict[str, Any]) -> None:
        """Install a state verbatim.  Sync broadcasts carry merged states
        with ``delta=None``, so installing one resets the local delta —
        its samples are already inside the merged base."""
        self._base = state.get("base")
        self._delta = state.get("delta")

    def merge_states(self, states: List[Dict[str, Any]]) -> Dict[str, Any]:
        # Every runner shares the same base after a sync; fold each
        # runner's delta in exactly once.
        base = None
        for s in states:
            if s and s.get("base") is not None:
                base = s["base"]
                break
        for s in states:
            if s:
                base = self._merge_agg(base, s.get("delta"))
        return {"base": base, "delta": None}


class FrameStack(Connector):
    """Stack the last k observations per sub-env along the feature axis
    (reference: rllib FrameStackingEnvToModule).  Expects a fixed batch
    (one row per sub-env) each call; reset() clears history."""

    def __init__(self, k: int = 4):
        self.k = k
        self.dim_factor = k
        self._frames: Optional[deque] = None
        self._reset_mask: Optional[np.ndarray] = None

    def reset(self) -> None:
        self._frames = None
        self._reset_mask = None

    def on_episode_boundaries(self, done_mask: np.ndarray) -> None:
        # Applied at the next __call__, whose batch carries the new
        # episodes' reset observations at the masked rows — the old
        # episode's frames must not leak into the new episode's stack.
        self._reset_mask = np.asarray(done_mask, bool).copy()

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        batch = np.array(batch, np.float32)  # own copy: frames are mutated
        if self._frames is None or self._frames[0].shape != batch.shape:
            self._frames = deque([batch] * self.k, maxlen=self.k)
        else:
            self._frames.append(batch)
            if self._reset_mask is not None and self._reset_mask.any():
                m = self._reset_mask
                for f in self._frames:
                    f[m] = batch[m]
        self._reset_mask = None
        return np.concatenate(list(self._frames), axis=-1)

    def transform(self, batch: np.ndarray) -> np.ndarray:
        batch = np.asarray(batch, np.float32)
        if self._frames is None or self._frames[0].shape != batch.shape:
            return np.concatenate([batch] * self.k, axis=-1)
        frames = list(self._frames)[1:] + [batch]
        return np.concatenate(frames, axis=-1)


class LambdaConnector(Connector):
    """Wrap a stateless function (reference: custom ConnectorV2 one-offs)."""

    def __init__(self, fn: Callable[[np.ndarray], np.ndarray]):
        self.fn = fn

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        return self.fn(batch)


class ClipActions(Connector):
    """Clip continuous actions into the env's bounds (module-to-env,
    reference: rllib's clip_actions config)."""

    def __init__(self, low: float, high: float):
        self.low = low
        self.high = high

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        return np.clip(batch, self.low, self.high)


class RewardClip(Connector):
    """Clip (or sign-compress) rewards before learning — the standard
    Atari-style stabilizer (reference: rllib clip_rewards config: True ->
    sign, float -> symmetric clip)."""

    def __init__(self, bound: float = 1.0, sign: bool = False):
        self.bound = bound
        self.sign = sign

    def __call__(self, rewards: np.ndarray) -> np.ndarray:
        r = np.asarray(rewards)
        if self.sign:
            return np.sign(r)
        return np.clip(r, -self.bound, self.bound)


class ObsFlatten(Connector):
    """Flatten structured observations to 1-D feature vectors
    (env-to-module; reference: rllib's flatten_observations preprocessor)."""

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        b = np.asarray(batch)
        return b.reshape(b.shape[0], -1) if b.ndim > 1 else b
