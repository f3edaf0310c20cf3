"""Logical-axis sharding rules (counterpart of ray_tpu/parallel/sharding.py).

Model code names each array dimension with a *logical* name ("batch",
"embed", "heads", "mlp", "vocab", "layers", ...); a ``ShardingRules`` table
maps each name to zero or more mesh axes.  ``logical_to_placements`` turns a
tuple of logical names into ``torch.distributed.tensor`` placements on the
port's mesh, one per mesh dim: ``Shard(d)`` on every mesh dim the rules name
for dimension ``d``, ``Replicate()`` elsewhere, with JAX's rule that one mesh
axis shards at most one dimension of an array.  ``NamedSharding`` is the pair
(mesh, placements), the counterpart of ``jax.sharding.NamedSharding``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from .mesh import (AXIS_DATA, AXIS_EXPERT, AXIS_FSDP, AXIS_PIPELINE,
                   AXIS_SEQ, AXIS_TENSOR, CANONICAL_ORDER, Mesh)

MeshAxes = Union[None, str, Tuple[str, ...]]


@dataclass
class ShardingRules:
    rules: Dict[str, MeshAxes] = field(default_factory=dict)

    def axes_for(self, logical: str) -> MeshAxes:
        return self.rules.get(logical)

    def replace(self, **updates: MeshAxes) -> "ShardingRules":
        merged = dict(self.rules)
        merged.update(updates)
        return ShardingRules(merged)


def default_rules() -> ShardingRules:
    """FSDP+TP+SP+EP layout for transformer LMs (the JAX package's table):
    batch over (dp, fsdp), the embed dim of every weight over fsdp,
    heads/kv_heads/mlp/vocab over tp, sequence over sp, experts over ep."""
    return ShardingRules({
        "batch": (AXIS_DATA, AXIS_FSDP),
        "seq": AXIS_SEQ,
        "embed": AXIS_FSDP,
        "heads": AXIS_TENSOR,
        "kv_heads": AXIS_TENSOR,
        "head_dim": None,
        "mlp": AXIS_TENSOR,
        "vocab": AXIS_TENSOR,
        "expert": AXIS_EXPERT,
        "layers": None,
        "stage": AXIS_PIPELINE,
        "norm": None,
    })


def logical_to_mesh_axes(logical_axes: Sequence[Optional[str]],
                         rules: ShardingRules
                         ) -> List[Tuple[str, ...]]:
    """The mesh axes sharding each dimension (JAX's ``PartitionSpec``
    entries as tuples): a mesh axis shards at most one dimension, the
    first that names it."""
    entries: List[Tuple[str, ...]] = []
    used: set = set()
    for name in logical_axes:
        axes = rules.axes_for(name) if name is not None else None
        if axes is None:
            entries.append(())
            continue
        axes_t = (axes,) if isinstance(axes, str) else tuple(axes)
        axes_t = tuple(a for a in axes_t if a not in used)
        used.update(axes_t)
        entries.append(axes_t)
    return entries


def logical_to_placements(logical_axes: Sequence[Optional[str]],
                          rules: Optional[ShardingRules] = None,
                          mesh: Optional[Mesh] = None) -> list:
    """('batch', 'seq', 'embed') -> one placement per mesh dim in
    ``CANONICAL_ORDER``: dp and fsdp ``Shard(0)``, sp ``Shard(1)``... and
    ``Replicate()`` on every mesh dim no dimension names.  A dimension
    sharded over several mesh axes is split over them outermost first, as
    DTensor splits it in mesh-dim order; the rules must list such axes in
    ``CANONICAL_ORDER`` (JAX's major-to-minor order), or this raises.
    ``mesh`` is accepted for JAX's signature; placements do not depend on
    axis sizes."""
    from torch.distributed.tensor import Replicate, Shard
    rules = rules or default_rules()
    out = [Replicate() for _ in CANONICAL_ORDER]
    for dim, axes in enumerate(logical_to_mesh_axes(logical_axes, rules)):
        order = [CANONICAL_ORDER.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(
                f"dimension {dim} is sharded over {axes}: the port splits a "
                f"dimension over mesh axes in {CANONICAL_ORDER} order only")
        for i in order:
            out[i] = Shard(dim)
    return out


def block_index(global_shape: Sequence[int], mesh_sizes: Sequence[int],
                coordinate: Sequence[int], placements: Sequence[Any]
                ) -> Tuple[Tuple[int, int], ...]:
    """The (start, stop) box of a global array that the rank at
    ``coordinate`` (one index a mesh dim) holds under ``placements``:
    DTensor's chunks (``torch.chunk``: ceil-sized, the last ones shorter or
    empty), a dimension split over several mesh dims in mesh-dim order."""
    box = [(0, int(d)) for d in global_shape]
    for n, c, p in zip(mesh_sizes, coordinate, placements):
        if not p.is_shard():
            continue
        lo, hi = box[p.dim]
        step = -(-(hi - lo) // n)
        start = min(lo + c * step, hi)
        box[p.dim] = (start, min(start + step, hi))
    return tuple(box)


def dtensor_index(t) -> Tuple[Tuple[int, int], ...]:
    """The box of a DTensor's global array that this rank's block holds."""
    dm = t.device_mesh
    return block_index(t.shape, dm.shape, dm.get_coordinate(), t.placements)


def is_primary(t) -> bool:
    """True where this rank holds the copy of a DTensor's block that is
    written or counted once: index 0 on every mesh dim the DTensor is
    replicated over."""
    return all(p.is_shard() or c == 0 for p, c in zip(
        t.placements, t.device_mesh.get_coordinate()))


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and the placements of one array on it."""
    mesh: Mesh
    placements: Tuple[Any, ...]

    def local_index(self, global_shape: Sequence[int],
                    coordinate: Optional[Dict[str, int]] = None
                    ) -> Tuple[Tuple[int, int], ...]:
        """The (start, stop) box of the global array that the rank at
        ``coordinate`` (axis -> index; default: this rank) holds
        (``block_index``)."""
        coordinate = coordinate or {a: self.mesh.coordinate(a)
                                    for a in CANONICAL_ORDER}
        return block_index(global_shape,
                           [self.mesh.shape[a] for a in CANONICAL_ORDER],
                           [coordinate[a] for a in CANONICAL_ORDER],
                           self.placements)


def named_sharding(mesh: Mesh, logical_axes: Sequence[Optional[str]],
                   rules: Optional[ShardingRules] = None) -> NamedSharding:
    return NamedSharding(mesh, tuple(logical_to_placements(
        logical_axes, rules or default_rules(), mesh)))


def is_logical(x: Any) -> bool:
    """A leaf of a logical-axes tree: a tuple of names and Nones."""
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def map_logical(fn, logical_tree: Any, *rest: Any) -> Any:
    """``fn(logical, *leaves)`` over the logical-axis tuples of
    ``logical_tree`` (dicts of them, and None leaves), in its structure."""
    if logical_tree is None or is_logical(logical_tree):
        return fn(logical_tree, *rest)
    if isinstance(logical_tree, dict):
        return {k: map_logical(fn, v, *(r[k] for r in rest))
                for k, v in logical_tree.items()}
    raise TypeError(f"not a logical-axes tree node: {logical_tree!r}")


def distribute(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """The full array ``x`` (the same on every rank) as a DTensor laid out
    by ``sharding``: each rank copies its own block (``local_index``) onto
    the mesh's device, so nothing is sent and nothing of ``x`` stays
    referenced.  On the one-device mesh, ``x`` on the mesh's device."""
    mesh = sharding.mesh
    if mesh.device_mesh is None:
        return x.to(mesh.device)
    from torch.distributed.tensor import DTensor
    box = sharding.local_index(x.shape)
    part = x[tuple(slice(lo, hi) for lo, hi in box)]
    block = torch.empty(part.shape, dtype=x.dtype,
                        device=mesh.device).copy_(part)
    return DTensor.from_local(block, mesh.device_mesh, sharding.placements,
                              run_check=False, shape=x.shape,
                              stride=torch.empty(x.shape, device="meta")
                              .stride())


def shard_pytree(tree: Any, logical_tree: Any, mesh: Mesh,
                 rules: Optional[ShardingRules] = None) -> Any:
    """Place a tree of full arrays by a parallel tree of logical axes."""
    rules = rules or default_rules()
    return map_logical(
        lambda logical, x: distribute(
            x, named_sharding(mesh, logical or (None,) * x.dim(), rules)),
        logical_tree, tree)


def pspec_pytree(logical_tree: Any,
                 rules: Optional[ShardingRules] = None) -> Any:
    """Parallel tree of placements from a tree of logical axes (JAX: of
    PartitionSpecs)."""
    rules = rules or default_rules()
    return map_logical(
        lambda logical: None if logical is None
        else logical_to_placements(logical, rules), logical_tree)


def constrain(x: torch.Tensor, logical_axes: Sequence[Optional[str]],
              rules: Optional[ShardingRules] = None) -> torch.Tensor:
    """A DTensor ``x`` redistributed to the layout of ``logical_axes`` (JAX:
    ``with_sharding_constraint``); a plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, logical_to_placements(
        logical_axes, rules or default_rules()))
