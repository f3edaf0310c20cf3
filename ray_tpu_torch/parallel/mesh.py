"""Device mesh description (counterpart of ray_tpu/parallel/mesh.py).

``MeshSpec`` carries the JAX package's named axis sizes, -1 on one axis
meaning "absorb the rest".  ``build_mesh`` builds the one-device mesh the
training step runs on; any axis larger than 1 raises ``NotImplementedError``
(sharding over several cards comes with a later slice), never a quiet run on
one device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from .._device import DeviceLike, resolve_device

_AXES = ("dp", "fsdp", "tp", "sp", "ep", "pp")


@dataclass
class MeshSpec:
    """Named mesh-axis sizes.  -1 on one axis means "absorb the rest"."""
    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1
    # Number of DCN-connected slices; dp must be divisible by it.
    num_slices: int = 1


@dataclass(frozen=True)
class Mesh:
    """A one-device mesh: every axis of ``spec`` is 1."""
    spec: MeshSpec
    device: torch.device


def build_mesh(spec: MeshSpec = None, device: DeviceLike = None) -> Mesh:
    """The mesh of ``spec`` on ``device`` (None: the card).  An axis of -1
    absorbs the one device; any axis larger than 1, or more than one slice,
    raises ``NotImplementedError``."""
    spec = spec or MeshSpec()
    sizes = {a: getattr(spec, a) for a in _AXES}
    if sum(s == -1 for s in sizes.values()) > 1:
        raise ValueError("at most one mesh axis may be -1")
    if any(s < 1 and s != -1 for s in sizes.values()):
        raise ValueError(f"mesh axis sizes must be positive or -1: {sizes}")
    wide = {a: s for a, s in sizes.items() if s > 1}
    if wide or spec.num_slices > 1:
        raise NotImplementedError(
            f"mesh axes {wide or {'num_slices': spec.num_slices}}: sharding "
            "over several cards comes with a later slice of the port "
            "(ROADMAP Queue 1 item 2: multi-device mesh and "
            "torch.distributed)")
    return Mesh(spec=dataclasses.replace(spec, **{a: 1 for a in _AXES}),
                device=resolve_device(device))
