"""Device mesh construction (counterpart of ray_tpu/parallel/mesh.py).

``MeshSpec`` carries the JAX package's named axis sizes, -1 on one axis
meaning "absorb the rest", and resolves against a device count exactly as
JAX's does.  ``build_mesh`` lays the axes over the ranks of the initialised
``torch.distributed`` world, one card (or CPU process) a rank: a
``torch.distributed.device_mesh.DeviceMesh`` with one dim per axis in
``CANONICAL_ORDER`` (outermost first), named as JAX names them.  With one
rank and every axis 1 it is the one-device mesh of plain tensors, with no
process group at all.

The rank layout is row-major over ``CANONICAL_ORDER``, so ``dp`` is the
outermost axis that is not ``pp``.  With ``num_slices`` > 1, ``dp`` splits
into (slice, dp-in-slice) as JAX's ``create_hybrid_device_mesh`` does: slice
``s`` holds the contiguous ranks of dp indices ``[s * dp / S, (s + 1) * dp /
S)``, which is the flat layout itself, so a multi-slice mesh computes
exactly what the flat mesh of the same axes computes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from .._device import DeviceLike, resolve_device

_GLOBAL_MESH = None


def set_global_mesh(mesh) -> None:
    """Install the ambient mesh (JAX: for ops that need it inside a
    forward; the port's sharded step installs its own)."""
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh


def get_global_mesh():
    return _GLOBAL_MESH


AXIS_DATA = "dp"
AXIS_FSDP = "fsdp"
AXIS_TENSOR = "tp"
AXIS_SEQ = "sp"
AXIS_EXPERT = "ep"
AXIS_PIPELINE = "pp"

# Outer-to-inner ordering, as in the JAX package.
CANONICAL_ORDER = (AXIS_PIPELINE, AXIS_DATA, AXIS_FSDP, AXIS_EXPERT,
                   AXIS_SEQ, AXIS_TENSOR)


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

    def axis_sizes(self) -> Dict[str, int]:
        return {AXIS_DATA: self.dp, AXIS_FSDP: self.fsdp,
                AXIS_TENSOR: self.tp, AXIS_SEQ: self.sp,
                AXIS_EXPERT: self.ep, AXIS_PIPELINE: self.pp}

    def resolved(self, n_devices: int) -> "MeshSpec":
        sizes = self.axis_sizes()
        unknown = [a for a, s in sizes.items() if s == -1]
        if len(unknown) > 1:
            raise ValueError("at most one mesh axis may be -1")
        known = 1
        for a, s in sizes.items():
            if s != -1:
                known *= s
        if unknown:
            if n_devices % known:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {known}")
            sizes[unknown[0]] = n_devices // known
        else:
            total = known
            if total != n_devices:
                raise ValueError(
                    f"mesh {sizes} needs {total} devices, got {n_devices}")
        return MeshSpec(dp=sizes[AXIS_DATA], fsdp=sizes[AXIS_FSDP],
                        tp=sizes[AXIS_TENSOR], sp=sizes[AXIS_SEQ],
                        ep=sizes[AXIS_EXPERT], pp=sizes[AXIS_PIPELINE],
                        num_slices=self.num_slices)

    def shape(self) -> Tuple[Tuple[str, int], ...]:
        sizes = self.axis_sizes()
        return tuple((a, sizes[a]) for a in CANONICAL_ORDER)


@dataclass(frozen=True)
class Mesh:
    """A resolved mesh: its spec, this rank's device and, over several
    ranks, the ``DeviceMesh`` (None for the one-device mesh)."""
    spec: MeshSpec
    device: torch.device
    device_mesh: Optional[object] = None
    #: axes -> this rank's process group over them (``group``).
    _groups: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, outermost first (JAX's ``Mesh.shape``)."""
        return dict(self.spec.shape())

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 on the one-device mesh)."""
        if self.device_mesh is None:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: Union[str, Tuple[str, ...]]):
        """The process group of ``axis`` through this rank; for a tuple of
        axes, of the ranks that differ only along them, ranked row-major
        over them in ``CANONICAL_ORDER`` (created on first use: every rank
        must ask for the same axes in the same order)."""
        if isinstance(axis, str):
            return self.device_mesh.get_group(axis)
        axes = tuple(a for a in CANONICAL_ORDER if a in axis)
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        if axes not in self._groups:
            import torch.distributed as dist
            sizes = [s for _, s in self.spec.shape()]
            dims = [CANONICAL_ORDER.index(a) for a in axes]
            rest = [d for d in range(len(sizes)) if d not in dims]
            layout = torch.arange(dist.get_world_size()).reshape(sizes)
            rows = layout.permute(rest + dims).reshape(
                -1, int(np.prod([sizes[d] for d in dims])))
            self._groups[axes] = dist.new_subgroups_by_enumeration(
                rows.tolist())[0]
        return self._groups[axes]

    @property
    def slice_index(self) -> int:
        """This rank's slice: its dp index over dp / num_slices."""
        return self.coordinate(AXIS_DATA) // (self.spec.dp
                                              // self.spec.num_slices)


def build_mesh(spec: Optional[MeshSpec] = None,
               device: DeviceLike = None) -> Mesh:
    """The mesh of ``spec`` over the ranks of the initialised
    ``torch.distributed`` world (one rank when none is initialised).

    One rank: the one-device mesh on ``device`` (None: the card).  Several:
    a ``DeviceMesh`` over every rank with one dim per axis of
    ``CANONICAL_ORDER`` and the JAX axis names, of device type "cuda" under
    NCCL (``device`` None: this process's current card) and "cpu" under
    gloo.  Raises ``ValueError`` where the spec does not resolve to the
    world size or ``dp`` does not divide into ``num_slices``."""
    import torch.distributed as dist
    spec = spec or MeshSpec()
    world = dist.get_world_size() if dist.is_initialized() else 1
    spec = spec.resolved(world)
    if spec.num_slices < 1 or spec.dp % spec.num_slices:
        raise ValueError("dp axis must be divisible by num_slices")
    if world == 1:
        return Mesh(spec=spec, device=resolve_device(device))
    from torch.distributed.device_mesh import DeviceMesh
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if device_type == "cuda":
        dev = (resolve_device(device) if device is not None
               else torch.device("cuda", torch.cuda.current_device()))
    else:
        dev = torch.device("cpu")
    sizes = [s for _, s in spec.shape()]
    layout = torch.arange(world).reshape(sizes)
    return Mesh(spec=spec, device=dev, device_mesh=DeviceMesh(
        device_type, layout, mesh_dim_names=CANONICAL_ORDER))
