"""Compiled graphs over the port's actors: lazy DAGs of actor-method calls
executed over channels (counterpart of ray_tpu/dag).

Reference: python/ray/dag/ — DAGNode (dag_node.py), InputNode/
InputAttributeNode (input_node.py), ClassMethodNode, MultiOutputNode
(output_node.py), ``experimental_compile`` (dag/compiled_dag_node.py:804
CompiledDAG).  Interpreted ``execute`` submits ordinary calls to the
port's process actors (``ray_tpu_torch._actor``) and returns their
``ObjectRef``s; compiled execution replaces per-call RPC with a resident
loop on each actor exchanging messages over shared-memory channels
(``channel.py``): plan once, push data through a static pipeline.

Example::

    with InputNode() as inp:
        x = a.step.bind(inp)
        y = b.step.bind(x)
    dag = y.experimental_compile()
    ref = dag.execute(batch)
    out = ref.get()
    dag.teardown()

Actor classes, and every function a bound argument holds, pickle by
reference (``_actor``): define them at the top level of a module.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from .channel import ChannelClosedError, ChannelTimeoutError, ShmChannel
from .compiled_dag import CompiledDAG

__all__ = ["DAGNode", "InputNode", "InputAttributeNode", "ClassMethodNode",
           "MultiOutputNode", "CompiledDAG", "ShmChannel",
           "ChannelTimeoutError", "ChannelClosedError",
           "CollectiveOutputNode", "allreduce_bind"]


class DAGNode:
    """Base class for graph nodes.  Nodes are immutable once bound."""

    def _upstream(self) -> List["DAGNode"]:
        """Direct DAGNode dependencies of this node."""
        return []

    # -- interpreted execution --------------------------------------------

    def execute(self, *args, **kwargs):
        """Execute the DAG by submitting ordinary actor calls; returns the
        ObjectRef(s) of this node's result (reference: dag_node.py
        execute)."""
        memo: Dict[int, Any] = {}
        return self._eval(memo, args, kwargs)

    def _eval(self, memo: Dict[int, Any], args, kwargs):
        key = id(self)
        if key not in memo:
            memo[key] = self._eval_impl(memo, args, kwargs)
        return memo[key]

    def _eval_impl(self, memo, args, kwargs):
        raise NotImplementedError

    # -- compiled execution ------------------------------------------------

    def experimental_compile(self, *, buffer_size_bytes: int = 1 << 20,
                             submit_timeout: float = 30.0) -> CompiledDAG:
        return CompiledDAG(self, buffer_size_bytes=buffer_size_bytes,
                           submit_timeout=submit_timeout)


class InputNode(DAGNode):
    """The DAG's input placeholder; a context manager for bind-time use
    (reference: dag/input_node.py)."""

    def __init__(self):
        self._attr_cache: Dict[Any, "InputAttributeNode"] = {}

    def __enter__(self) -> "InputNode":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __getitem__(self, key: int) -> "InputAttributeNode":
        if key not in self._attr_cache:
            self._attr_cache[key] = InputAttributeNode(self, key)
        return self._attr_cache[key]

    def __getattr__(self, key: str) -> "InputAttributeNode":
        if key.startswith("_"):
            raise AttributeError(key)
        if key not in self._attr_cache:
            self._attr_cache[key] = InputAttributeNode(self, key)
        return self._attr_cache[key]

    def _eval_impl(self, memo, args, kwargs):
        if kwargs and not args:
            return kwargs
        if len(args) == 1 and not kwargs:
            return args[0]
        return args

    @staticmethod
    def extract(key: Any, args, kwargs):
        """Value an InputAttributeNode yields for execute(*args, **kwargs)."""
        if isinstance(key, int):
            return args[key]
        return kwargs[key]


class InputAttributeNode(DAGNode):
    """``inp[i]`` / ``inp.key`` — a positional/keyword slice of the input."""

    def __init__(self, parent: InputNode, key: Any):
        self._parent = parent
        self._key = key

    def _upstream(self) -> List[DAGNode]:
        return [self._parent]

    def _eval_impl(self, memo, args, kwargs):
        return InputNode.extract(self._key, args, kwargs)


class ClassMethodNode(DAGNode):
    """A bound actor-method call (reference: dag/class_node.py)."""

    def __init__(self, actor_handle, method_name: str,
                 bound_args: Tuple, bound_kwargs: Dict[str, Any]):
        self._actor = actor_handle
        self._method = method_name
        self._args = bound_args
        self._kwargs = bound_kwargs

    def _upstream(self) -> List[DAGNode]:
        return ([a for a in self._args if isinstance(a, DAGNode)]
                + [v for v in self._kwargs.values() if isinstance(v, DAGNode)])

    def _eval_impl(self, memo, args, kwargs):
        r_args = [a._eval(memo, args, kwargs) if isinstance(a, DAGNode)
                  else a for a in self._args]
        r_kwargs = {k: a._eval(memo, args, kwargs)
                    if isinstance(a, DAGNode) else a
                    for k, a in self._kwargs.items()}
        # An upstream ObjectRef is a top-level argument: the actor runtime
        # resolves it to its value before the call is sent.
        method = getattr(self._actor, self._method)
        return method.remote(*r_args, **r_kwargs)

    def __repr__(self):
        return (f"ClassMethodNode({self._actor._class_name}."
                f"{self._method})")


class MultiOutputNode(DAGNode):
    """Marks several nodes as the DAG outputs; execute returns a list
    (reference: dag/output_node.py)."""

    def __init__(self, outputs: List[DAGNode]):
        self._outputs = list(outputs)

    def _upstream(self) -> List[DAGNode]:
        return list(self._outputs)

    def _eval_impl(self, memo, args, kwargs):
        return [o._eval(memo, args, kwargs) for o in self._outputs]


# Collective nodes import DAGNode from this module, so this import must sit
# below the class definitions (reference: dag/collective_node.py).
from .collective import CollectiveOutputNode, allreduce_bind  # noqa: E402
