"""The optimizer of the training step: the port's own copy of the optax
behaviour that ``ray_tpu/parallel/spmd.py`` relies on
(``optax.adamw(lr, b1=0.9, b2=0.95, weight_decay=0.1)``), and
``global_norm``.

``adam``, ``clip_by_global_norm``, ``chain`` and ``apply_updates`` are the
functional optax transformations the RL learners use (``ray_tpu/rl``).

``adamw`` follows ``optax.adamw`` with its defaults (``eps_root=0``,
``mu_dtype=None``, ``mask=None``): mu and nu in the params' dtype,
bias-corrected m_hat / (sqrt(v_hat) + eps) with the correction cast to each
moment's dtype before the division, plus decoupled weight decay ``wd * p``
on every leaf (norms and embedding included), all times ``-lr``.  A
learning rate may be a schedule, a callable of the step count (0 at the
first update) as optax's ``ScalarOrSchedule`` is.

Unlike optax, ``update`` applies the step to the parameters in place with
``torch._foreach_*`` ops and uses the gradients as scratch: the port's form
of ``donate_argnums``, so params, grads, mu and nu never exist twice.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ._tree import tree_leaves, tree_map

_INT32_MAX = np.iinfo(np.int32).max
_NORM = threading.local()


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``, a named tuple of the same fields:
    ``count`` is an int32 scalar kept on the CPU (the bias correction needs
    it on the host every step); ``mu`` and ``nu`` mirror the params' tree
    (DTensors with their params' placements on a mesh of several
    ranks)."""
    count: torch.Tensor
    mu: Any
    nu: Any


class EmptyState(NamedTuple):
    """optax's ``EmptyState``: the state of a transformation that keeps
    none (adamw's weight decay and learning-rate scaling)."""


class ScaleByScheduleState(NamedTuple):
    """optax's ``ScaleByScheduleState``: the step count a learning-rate
    schedule reads (an int32 CPU scalar)."""
    count: torch.Tensor


def _rate(learning_rate, count: int) -> float:
    """The learning rate at step ``count`` (the number of updates made
    before this one): a float, or a schedule called on the count."""
    if callable(learning_rate):
        return float(learning_rate(count))
    return learning_rate


def optax_state(state: AdamState) -> tuple:
    """The port's adamw state in the layout of optax's
    ``adamw(...).init(params)``: (ScaleByAdamState, EmptyState(),
    EmptyState()), for a checkpoint the JAX package reads as its own."""
    return (state, EmptyState(), EmptyState())


def from_optax_state(tree: Any) -> AdamState:
    """The inverse of ``optax_state`` (any tuple holding one AdamState)."""
    if isinstance(tree, AdamState):
        return tree
    for node in tree:
        if isinstance(node, AdamState):
            return node
    raise ValueError("no adam state (count, mu, nu) in the given tree")


def _correction(decay: float, count: int, dtype: torch.dtype) -> float:
    """1 - decay**count in fp32, then rounded to ``dtype`` (optax's
    ``tree_bias_correction``)."""
    c = np.float32(1.0) - np.power(np.float32(decay), np.float32(count),
                                   dtype=np.float32)
    return torch.tensor(float(c), dtype=torch.float32).to(dtype).item()


class AdamW:
    def __init__(self, learning_rate, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params: Any) -> AdamState:
        zeros = lambda p: torch.zeros_like(p, requires_grad=False)
        return AdamState(count=torch.zeros((), dtype=torch.int32),
                         mu=tree_map(zeros, params),
                         nu=tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads: Any, state: AdamState,
               params: Any) -> AdamState:
        """One adamw step on ``params`` in place; returns the new state
        (``mu``/``nu`` updated in place).  ``grads`` are overwritten.

        DTensor trees (a mesh of several ranks) update through their local
        blocks: every leaf's param, gradient, mu and nu must share one
        layout, so the elementwise step on each rank's blocks is the step
        of the whole arrays.  (DTensor's own ``_foreach_`` dispatch plans
        every op over all six mesh dims, which takes minutes a step.)"""
        g, p, mu, nu = _local_blocks(
            [tree_leaves(t) for t in (grads, params, state.mu, state.nu)])
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - b2)
        lr = _rate(self.learning_rate, int(state.count))
        count = min(int(state.count) + 1, _INT32_MAX)
        for dtype in dict.fromkeys(t.dtype for t in p):
            idx = [i for i, t in enumerate(p) if t.dtype == dtype]
            pd, gd = [p[i] for i in idx], [g[i] for i in idx]
            mud, nud = [mu[i] for i in idx], [nu[i] for i in idx]
            # gd becomes sqrt(nu_hat) + eps, then u = mu_hat / gd.
            torch._foreach_copy_(gd, nud)
            torch._foreach_div_(gd, _correction(b2, count, dtype))
            torch._foreach_sqrt_(gd)
            torch._foreach_add_(gd, self.eps)
            u = torch._foreach_div(mud, _correction(b1, count, dtype))
            torch._foreach_div_(u, gd)
            torch._foreach_add_(u, pd, alpha=self.weight_decay)
            torch._foreach_add_(pd, u, alpha=-lr)
        return AdamState(count=torch.tensor(count, dtype=torch.int32),
                         mu=state.mu, nu=state.nu)


def _local_blocks(lists):
    """Parallel leaf lists -> the same lists of plain tensors: a DTensor's
    local block (a view: updating it updates the DTensor), after checking
    that the leaves at one position share a mesh and placements.  No list
    ever mixes DTensors and plain tensors."""
    from torch.distributed.tensor import DTensor
    kinds = {isinstance(t, DTensor) for ts in lists for t in ts}
    if kinds != {True}:
        if True in kinds:
            raise ValueError("adamw: a tree mixes DTensors and plain "
                             "tensors")
        return lists
    for ts in zip(*lists):
        layouts = {(t.device_mesh, tuple(t.placements)) for t in ts}
        if len(layouts) != 1:
            raise ValueError(f"adamw: a param, its gradient, mu and nu "
                             f"have different layouts: {layouts}")
    return [[t.to_local() for t in ts] for ts in lists]


def adamw(learning_rate, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> AdamW:
    """``optax.adamw`` with ``init(params)`` and ``update(grads, state,
    params)`` (in place, see the module docstring).  ``learning_rate``: a
    float or a schedule of the step count (the count before this update,
    as optax's ``scale_by_schedule`` reads it)."""
    return AdamW(learning_rate, b1=b1, b2=b2, eps=eps,
                 weight_decay=weight_decay)


@contextlib.contextmanager
def blockwise_norm(norm_fn: Callable):
    """Within the block, ``global_norm(tree)`` is ``norm_fn(leaves)`` on
    this thread: the sharded training step runs an optax-shaped
    transformation on each rank's local blocks, whose global norm is a sum
    over the ranks that ``norm_fn`` makes."""
    prev = getattr(_NORM, "fn", None)
    _NORM.fn = norm_fn
    try:
        yield
    finally:
        _NORM.fn = prev


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, as an fp32 scalar (each
    leaf's norm accumulated in fp32)."""
    leaves = tree_leaves(tree)
    norm_fn = getattr(_NORM, "fn", None)
    if norm_fn is not None:
        return norm_fn(leaves)
    norms = torch._foreach_norm(leaves, 2, dtype=torch.float32)
    return torch.linalg.vector_norm(torch.stack(norms))


# ----------------------------------------------------------------- optax-
# shaped transformations for the RL learners (``ray_tpu/rl/learner.py``'s
# ``optax.chain(optax.clip_by_global_norm(m), optax.adam(lr))`` and SAC's
# ``optax.adam``).  Functional, as optax is: ``update`` returns new update
# and state trees and never writes into its inputs, so a params tree handed
# out (a target network, ``get_weights``) stays a snapshot.  The states
# have optax's layout: ``adam(lr).init(p)`` is ``(AdamState(count, mu, nu),
# EmptyState())`` and ``chain(a, b).init(p)`` is ``(a.init(p), b.init(p))``.

class GradientTransformation(NamedTuple):
    """optax's ``GradientTransformation``: ``init(params) -> state`` and
    ``update(updates, state, params=None) -> (updates, state)``."""
    init: Callable
    update: Callable


def _empty_init(_params: Any) -> EmptyState:
    return EmptyState()


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """``optax.clip_by_global_norm``: each leaf becomes ``(t / norm) *
    max_norm`` when ``norm >= max_norm`` and stays as it is otherwise.
    (``torch.nn.utils.clip_grad_norm_`` scales by ``max_norm / (norm +
    1e-6)`` clamped at 1, which differs.)  The test runs on the device: no
    host sync."""

    def update(updates, state, params=None):
        g_norm = global_norm(updates)
        keep = g_norm < max_norm
        return tree_map(
            lambda t: torch.where(keep, t, (t / g_norm.to(t.dtype))
                                  * max_norm), updates), state

    return GradientTransformation(_empty_init, update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransformation:
    """``optax.scale_by_adam`` (``eps_root=0``, no nesterov): mu and nu in
    the params' dtype, ``count`` an int32 scalar kept on the CPU (the bias
    correction is computed on the host, in fp32 as optax does)."""

    def init(params):
        zeros = lambda p: torch.zeros_like(p, requires_grad=False)
        return AdamState(count=torch.zeros((), dtype=torch.int32),
                         mu=tree_map(zeros, params),
                         nu=tree_map(zeros, params))

    def update(updates, state, params=None):
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, updates, state.mu)
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, updates,
                      state.nu)
        count = min(int(state.count) + 1, _INT32_MAX)
        out = tree_map(
            lambda m, v: (m / _correction(b1, count, m.dtype))
            / (torch.sqrt(v / _correction(b2, count, v.dtype)) + eps),
            mu, nu)
        return out, AdamState(count=torch.tensor(count, dtype=torch.int32),
                              mu=mu, nu=nu)

    return GradientTransformation(init, update)


def scale_by_learning_rate(learning_rate) -> GradientTransformation:
    """``optax.scale_by_learning_rate``: updates times ``-learning_rate``.
    A schedule (a callable of the step count) keeps the count in a
    ``ScaleByScheduleState``, as optax's ``scale_by_schedule`` does, and
    scales by ``-schedule(count)`` cast to each update's dtype."""
    if callable(learning_rate):
        def init(params):
            return ScaleByScheduleState(torch.zeros((), dtype=torch.int32))

        def update(updates, state, params=None):
            count = int(state.count)
            step = -_rate(learning_rate, count)
            # The step rounded to each update's dtype on the host.
            return (tree_map(lambda u: float(torch.tensor(
                step, dtype=u.dtype)) * u, updates),
                    ScaleByScheduleState(torch.tensor(
                        min(count + 1, _INT32_MAX), dtype=torch.int32)))

        return GradientTransformation(init, update)
    return GradientTransformation(
        _empty_init,
        lambda updates, state, params=None: (
            tree_map(lambda u: -learning_rate * u, updates), state))


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    """``optax.chain``: the state is the tuple of the parts' states."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
    """``optax.adam``: ``chain(scale_by_adam, scale_by_learning_rate)``."""
    return chain(scale_by_adam(b1, b2, eps),
                 scale_by_learning_rate(learning_rate))


def apply_updates(params: Any, updates: Any) -> Any:
    """``optax.apply_updates``: ``p + u`` in each param's dtype, as new
    tensors."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
