"""Collective nodes for compiled DAGs: allreduce across actor outputs
(counterpart of ray_tpu/dag/collective.py).

Reference: python/ray/dag/collective_node.py:23 (_CollectiveOperation
binding N actor-method outputs to an NCCL allreduce, producing N outputs)
and ray.experimental.collective.allreduce.

As in the JAX package, DAG collectives cover the host side of a pipeline
of actors: each participant's contribution, a tree (``_tree``: dicts,
lists, tuples) of numpy arrays, scalars or torch tensors, is broadcast to
every peer over pairwise shm channels and reduced locally — one
iteration, no central hop, deadlock-free with capacity-1 channels because
all writes precede all reads.  Payloads cross by value (``compiled_dag``'s
docstring): a CUDA tensor contribution reaches each peer through the
host.  Collectives over the cards themselves are ``collective``'s process
groups (NCCL), not the DAG layer.
"""

from __future__ import annotations

from functools import reduce
from typing import Any, List

import numpy as np

from .._tree import tree_map

REDUCE_OPS = ("sum", "mean", "max", "min")


def _reduce_leaves(op: str, xs: List[Any]) -> Any:
    """One leaf's reduction.  Torch tensors reduce in torch on the first
    tensor's device (in order, as the host sum does) and give a tensor;
    anything else reduces as JAX's ``_tree_reduce`` does, in numpy."""
    import sys
    torch = sys.modules.get("torch")
    if torch is not None and any(isinstance(x, torch.Tensor) for x in xs):
        dev = next(x.device for x in xs if isinstance(x, torch.Tensor))
        ts = [torch.as_tensor(x).to(dev) for x in xs]
        if op in ("sum", "mean"):
            out = sum(ts)
            return out / len(ts) if op == "mean" else out
        return reduce(torch.maximum if op == "max" else torch.minimum, ts)
    if op == "sum":
        return sum(np.asarray(x) for x in xs)
    if op == "mean":
        return sum(np.asarray(x) for x in xs) / len(xs)
    if op == "max":
        return np.maximum.reduce([np.asarray(x) for x in xs])
    return np.minimum.reduce([np.asarray(x) for x in xs])


def _tree_reduce(op: str, values: List[Any]) -> Any:
    """Elementwise reduction over a list of same-structure trees."""
    return tree_map(lambda *xs: _reduce_leaves(op, list(xs)), *values)


class CollectiveGroup:
    """One allreduce over N same-structure contributions, one per actor."""

    def __init__(self, inputs: List[Any], op: str):
        from . import ClassMethodNode
        if op not in REDUCE_OPS:
            raise ValueError(f"unsupported collective op {op!r}; "
                             f"one of {REDUCE_OPS}")
        if len(inputs) < 2:
            raise ValueError("collective needs >= 2 participants")
        actor_ids = []
        for n in inputs:
            if not isinstance(n, ClassMethodNode):
                raise ValueError(
                    "collective participants must be actor method nodes, "
                    f"got {type(n).__name__}")
            actor_ids.append(n._actor._actor_id)
        if len(set(actor_ids)) != len(actor_ids):
            raise ValueError(
                "collective participants must live on distinct actors "
                "(reference: collective_node.py same constraint)")
        self.inputs = list(inputs)
        self.op = op


from . import DAGNode  # noqa: E402  (set by __init__ before the
#                        tail `from .collective import ...`)


class CollectiveOutputNode(DAGNode):
    """The reduced value as seen by participant ``rank``'s actor.

    Downstream steps on that actor consume it locally; it can also be a
    DAG output.  The compiled planner special-cases it into a peer-to-peer
    broadcast + local reduction step.
    """

    def __init__(self, group: CollectiveGroup, rank: int):
        self._group = group
        self._rank = rank
        self._actor = group.inputs[rank]._actor

    def _upstream(self):
        # Depends on every participant's input: the collective cannot fire
        # until all contributions exist (this also gives the compiler the
        # right topo order).
        return list(self._group.inputs)

    def _eval_impl(self, memo, args, kwargs):
        """Interpreted mode: reduce on the driver (reference: interpreted
        collective falls back to object-store gather)."""
        from .._actor import get
        gkey = ("collective", id(self._group))
        if gkey not in memo:
            refs = [n._eval(memo, args, kwargs)
                    for n in self._group.inputs]
            values = get(list(refs))
            memo[gkey] = _tree_reduce(self._group.op, values)
        return memo[gkey]

    def __repr__(self):
        return (f"CollectiveOutputNode({self._group.op}, rank={self._rank}, "
                f"actor={self._actor._class_name})")


def allreduce_bind(inputs: List[Any], op: str = "sum"
                   ) -> List[CollectiveOutputNode]:
    """Bind an allreduce across N actor-method nodes; returns one output
    node per participant, bound to the same actor (reference:
    ray.experimental.collective.allreduce.bind)."""
    group = CollectiveGroup(inputs, op)
    outputs = [CollectiveOutputNode(group, i) for i in range(len(inputs))]
    group.outputs = outputs
    return outputs
