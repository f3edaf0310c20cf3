"""Carry the JAX package's parameters and optimizer state over to the port.

``params_from_numpy`` turns a JAX parameter pytree (any nesting of dicts
whose leaves ``np.asarray`` accepts) into the port's dict of tensors.  The
layout is kept exactly: the stacked ``[L, ...]`` blocks and every axis order
of ``ray_tpu/models/llama.py:init_params``, with no transposes, so a test or
a checkpoint feeds both packages the same weights.  ``opt_state_from_numpy``
does the same for optax's adamw state, and ``optax_state_from_numpy`` for an
optax state of any nesting (the RL learners' ``chain(clip_by_global_norm,
adam)``: ``(EmptyState(), (ScaleByAdamState(count, mu, nu), EmptyState()))``)
node for node.  The RL params trees keep the JAX layouts too (the CNN's
``HWIO`` kernels, the GRU's fused ``w_x``/``w_h``, TQC's stacked ``[N, ...]``
critics), so ``params_from_numpy`` carries a JAX ``get_weights()`` over.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..optim import AdamState, EmptyState, ScaleByScheduleState


def _leaf(x, dtype: Optional[torch.dtype], device: torch.device):
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: torch reads bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree: Any, dtype: Optional[torch.dtype] = None,
                      device: DeviceLike = None) -> Any:
    """JAX pytree -> the same nesting of tensors on ``device``, cast to
    ``dtype`` where given (else each leaf keeps its own dtype)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        return _leaf(node, dtype, dev)

    return conv(tree)


def _find_adam(node):
    if all(hasattr(node, f) for f in ("count", "mu", "nu")):
        return node
    if isinstance(node, (list, tuple)):
        for v in node:
            found = _find_adam(v)
            if found is not None:
                return found
    return None


def opt_state_from_numpy(state: Any, device: DeviceLike = None) -> AdamState:
    """optax adamw state as numpy (``jax.tree.map(np.asarray, opt_state)``:
    the chain's tuple holding ``ScaleByAdamState(count, mu, nu)`` and two
    empty states) -> the port's ``optim.AdamState``.  mu and nu keep their
    dtypes and the params' layout; ``count`` becomes the int32 CPU scalar
    the port's adamw keeps."""
    adam = _find_adam(state)
    if adam is None:
        raise ValueError("no adam state (count, mu, nu) in the given tree")
    return AdamState(
        count=torch.tensor(int(np.asarray(adam.count)), dtype=torch.int32),
        mu=params_from_numpy(adam.mu, device=device),
        nu=params_from_numpy(adam.nu, device=device))


def optax_state_from_numpy(state: Any, device: DeviceLike = None) -> Any:
    """An optax state as numpy (tuples of ``ScaleByAdamState`` and
    ``EmptyState`` and ``ScaleByScheduleState``, any nesting, as
    ``optax.chain`` builds it) -> the same nesting of ``optim.AdamState``
    (``count`` an int32 CPU scalar), ``optim.EmptyState`` and
    ``optim.ScaleByScheduleState``."""
    dev = resolve_device(device)

    def conv(node):
        if _find_adam(node) is node:
            return opt_state_from_numpy(node, device=dev)
        if isinstance(node, tuple) and getattr(node, "_fields", None) == ():
            return EmptyState()
        if isinstance(node, tuple) and getattr(node, "_fields",
                                               None) == ("count",):
            return ScaleByScheduleState(
                torch.tensor(int(np.asarray(node.count)), dtype=torch.int32))
        if isinstance(node, (list, tuple)):
            return tuple(conv(v) for v in node)
        raise TypeError(f"unexpected optax state node {type(node)}")

    return conv(state)
