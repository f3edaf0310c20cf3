"""Resource model for scheduling.

A copy of ``ray_tpu/_private/resources.py`` with the card as the typed
resource: a node advertises ``CPU``, ``memory`` and ``GPU`` (its cards),
which takes the place of JAX's ``TPU``.  ``task_resources`` keeps JAX's
argument ``num_tpus``, which means cards here (as ``serve``'s does).

Quantities are floats with a fixed epsilon, matching the reference's
fixed-point semantics (0.0001 granularity) without the integer encoding.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping

EPSILON = 1e-4

CPU = "CPU"
#: The card (JAX: ``TPU``, its chips).
GPU = "GPU"
MEMORY = "memory"


class ResourceSet:
    __slots__ = ("_r",)

    def __init__(self, resources: Mapping[str, float] | None = None):
        self._r: Dict[str, float] = {}
        if resources:
            for k, v in resources.items():
                if v is None:
                    continue
                v = float(v)
                if v < 0:
                    raise ValueError(f"negative resource {k}={v}")
                if v > EPSILON / 2:
                    self._r[k] = v

    def get(self, name: str) -> float:
        return self._r.get(name, 0.0)

    def items(self):
        return self._r.items()

    def keys(self) -> Iterable[str]:
        return self._r.keys()

    def is_empty(self) -> bool:
        return not self._r

    def fits(self, available: "ResourceSet") -> bool:
        return all(available.get(k) + EPSILON >= v for k, v in self._r.items())

    def __add__(self, other: "ResourceSet") -> "ResourceSet":
        out = dict(self._r)
        for k, v in other._r.items():
            out[k] = out.get(k, 0.0) + v
        return ResourceSet(out)

    def __sub__(self, other: "ResourceSet") -> "ResourceSet":
        out = dict(self._r)
        for k, v in other._r.items():
            nv = out.get(k, 0.0) - v
            if nv < -EPSILON:
                raise ValueError(f"resource {k} would go negative: {nv}")
            out[k] = max(nv, 0.0)
        return ResourceSet(out)

    def to_dict(self) -> Dict[str, float]:
        return dict(self._r)

    def copy(self) -> "ResourceSet":
        return ResourceSet(self._r)

    def __eq__(self, other) -> bool:
        return isinstance(other, ResourceSet) and self._r == other._r

    def __repr__(self) -> str:
        return f"ResourceSet({self._r})"

    def __reduce__(self):
        return (ResourceSet, (self._r,))


def task_resources(num_cpus: float | None, num_tpus: float | None,
                   memory: float | None,
                   resources: Mapping[str, float] | None,
                   default_num_cpus: float = 1.0) -> ResourceSet:
    r: Dict[str, float] = dict(resources or {})
    if num_cpus is not None:
        r[CPU] = float(num_cpus)
    elif CPU not in r:
        # The default must not clobber an explicit CPU entry in the custom
        # resources dict (resources={"CPU": 1} on an actor means 1, not the
        # actor default of 0).
        r[CPU] = default_num_cpus
    if num_tpus is not None:
        r[GPU] = float(num_tpus)
    if memory is not None:
        r[MEMORY] = float(memory)
    return ResourceSet(r)
