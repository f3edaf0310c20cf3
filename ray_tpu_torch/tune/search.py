"""Search-space primitives + variant generation (a copy of
``ray_tpu/tune/search.py``).

Reference analog: python/ray/tune/search/ (BasicVariantGenerator grid/random
sampling, tune.grid_search / tune.choice / tune.uniform markers).
"""

from __future__ import annotations

import itertools
import math
import random
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence


@dataclass
class GridSearch:
    values: List[Any]


@dataclass
class Choice:
    values: List[Any]

    def sample(self, rng: random.Random) -> Any:
        return rng.choice(self.values)


@dataclass
class Uniform:
    low: float
    high: float

    def sample(self, rng: random.Random) -> float:
        return rng.uniform(self.low, self.high)


@dataclass
class LogUniform:
    low: float
    high: float

    def sample(self, rng: random.Random) -> float:
        return math.exp(rng.uniform(math.log(self.low), math.log(self.high)))


@dataclass
class RandInt:
    low: int
    high: int

    def sample(self, rng: random.Random) -> int:
        return rng.randrange(self.low, self.high)


def grid_search(values: Sequence[Any]) -> GridSearch:
    return GridSearch(list(values))


def choice(values: Sequence[Any]) -> Choice:
    return Choice(list(values))


def uniform(low: float, high: float) -> Uniform:
    return Uniform(low, high)


def loguniform(low: float, high: float) -> LogUniform:
    return LogUniform(low, high)


def randint(low: int, high: int) -> RandInt:
    return RandInt(low, high)


def generate_variants(param_space: Dict[str, Any], num_samples: int,
                      seed: int = 0) -> List[Dict[str, Any]]:
    """Grid axes expand combinatorially; samplers draw per variant; the
    whole set repeats num_samples times (reference: BasicVariantGenerator)."""
    rng = random.Random(seed)
    grid_keys = [k for k, v in param_space.items()
                 if isinstance(v, GridSearch)]
    grid_values = [param_space[k].values for k in grid_keys]
    variants: List[Dict[str, Any]] = []
    for _ in range(num_samples):
        for combo in itertools.product(*grid_values) if grid_keys else [()]:
            cfg: Dict[str, Any] = {}
            for k, v in param_space.items():
                if isinstance(v, GridSearch):
                    cfg[k] = combo[grid_keys.index(k)]
                elif isinstance(v, (Choice, Uniform, LogUniform, RandInt)):
                    cfg[k] = v.sample(rng)
                else:
                    cfg[k] = v
            variants.append(cfg)
    return variants
