"""Accelerator plugin interface (a copy of
``ray_tpu/accelerators/accelerator.py``).

The node plane's accelerator handling
(detection, chip pinning env, resource naming, slice topology) goes
through this ABC so heterogeneous hosts — CPU-only RL env-runner fleets,
a future GPU ferry tier — plug in without touching the node manager
(reference: python/ray/_private/accelerators/accelerator.py:16
AcceleratorManager ABC + the per-vendor managers registered in
accelerators/__init__.py).

``register_accelerator`` adds a manager; ``all_accelerators`` is what the
node plane iterates to build its resource set and per-worker visibility
env.  CUDAAcceleratorManager (``cuda.py``) is the built-in registration.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, List, Optional, Type


class AcceleratorManager(ABC):
    """One accelerator family (reference: accelerator.py:16).

    Implementations are stateless namespaces: every method is a class or
    static method so the node plane can use the type object directly.
    """

    # Resource string, e.g. "GPU" — keys the typed ResourceSet.
    resource_name: str = ""

    @staticmethod
    @abstractmethod
    def detect_num_chips() -> int:
        """Accelerators on this host, WITHOUT initializing a runtime
        (device nodes / env probes only — a worker must be able to call
        this before deciding whether to grab the device)."""

    @staticmethod
    @abstractmethod
    def visibility_env(chip_ids: List[int]) -> Dict[str, str]:
        """Env vars that pin a worker process to exactly ``chip_ids``
        (reference: set_current_process_visible_accelerator_ids)."""

    @staticmethod
    def accelerator_type() -> Optional[str]:
        """Family/type string for node labels (e.g. "v5e"), or None."""
        return None

    @staticmethod
    def slice_resources(accelerator_type: str) -> Dict[str, float]:
        """Per-host resource shape for gang-reserving a whole slice/pod
        of ``accelerator_type`` (empty: no multi-host gangs)."""
        return {}


_REGISTRY: Dict[str, Type[AcceleratorManager]] = {}


def register_accelerator(manager: Type[AcceleratorManager]) -> None:
    import inspect
    if not manager.resource_name:
        raise ValueError("accelerator manager needs a resource_name")
    if inspect.isabstract(manager):
        raise TypeError(
            f"{manager.__name__} is missing abstract methods: "
            f"{sorted(getattr(manager, '__abstractmethods__', ()))}")
    _REGISTRY[manager.resource_name] = manager


def all_accelerators() -> List[Type[AcceleratorManager]]:
    return list(_REGISTRY.values())


def get_accelerator(resource_name: str) -> Optional[Type[AcceleratorManager]]:
    return _REGISTRY.get(resource_name)
