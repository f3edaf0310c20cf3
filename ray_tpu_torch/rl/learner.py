"""Learning layer: TorchLearner + LearnerGroup.

Counterpart of ``ray_tpu/rl/learner.py`` (``JaxLearner`` ->
``TorchLearner``).  One update is the JAX learner's jitted ``grad_step``:
the loss, its gradients (``torch.autograd.grad`` over the params' leaves),
``optim.chain(clip_by_global_norm, adam)`` exactly as optax computes it,
and new params; the metrics dict comes back to the host in ONE transfer
(``ray_tpu/rl/learner.py:74-83``).  Params are never written in place: a
tree handed out by ``get_weights`` stays a snapshot, as a JAX array does.

``LearnerGroup`` runs one in-process learner (``num_learners=0``).
Learner actors with a gradient allreduce (``num_learners >= 1``) need the
port's process tier and raise ``NotImplementedError`` (ROADMAP Queue 1
item 6).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from .. import optim
from .._device import DeviceLike, make_generator, resolve_device
from .._tree import tree_map
from ._transfer import fetch_metrics, to_device

PROCESS_TIER = ("ROADMAP Queue 1 item 6 (the process tier: remote env "
                "runners, learner actors with an allreduce, IMPALA's async "
                "pipeline)")


def value_and_grad(fn: Callable, params: Any) -> Tuple[Any, Any]:
    """``jax.value_and_grad(fn, has_aux=True)(params)`` for a tree of
    tensors: (``fn``'s output, gradients in ``params``' structure).  A leaf
    the loss does not reach gets a zero gradient, as in JAX."""
    flat = []

    def leaf(t):
        flat.append(t.detach().requires_grad_(True))
        return flat[-1]

    with torch.enable_grad():
        p = tree_map(leaf, params)
        out = fn(p)
        loss = out[0] if isinstance(out, tuple) else out
        grads = iter(torch.autograd.grad(loss, flat, allow_unused=True,
                                         materialize_grads=True))
    return out, tree_map(lambda _t: next(grads), p)


def _detach(tree: Any) -> Any:
    return tree_map(lambda t: t.detach()
                    if isinstance(t, torch.Tensor) else t, tree)


class TorchLearner:
    """Owns params + optimizer state; applies updates.

    The loss: ``loss_fn(module, params, batch) -> (loss, metrics_dict)``.
    ``device`` None is the card; the params are drawn from a generator
    seeded ``seed`` there.
    """

    def __init__(self, module, loss_fn: Callable, *,
                 learning_rate: float = 3e-4, max_grad_norm: float = 0.5,
                 seed: int = 0, optimizer=None, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.module = module
        self.loss_fn = loss_fn
        self.optimizer = optimizer or optim.chain(
            optim.clip_by_global_norm(max_grad_norm),
            optim.adam(learning_rate))
        self.params = module.init(make_generator(self.device, seed))
        self.opt_state = self.optimizer.init(self.params)

    def update(self, batch: Dict[str, Any]) -> Dict[str, float]:
        """Fused grad+apply (reference: Learner.update:1028); the metrics
        come back in ONE device -> host transfer."""
        batch = to_device(batch, self.device)
        (loss, metrics), grads = value_and_grad(
            lambda p: self.loss_fn(self.module, p, batch), self.params)
        metrics = _detach(dict(metrics))
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = optim.global_norm(grads)
        with torch.no_grad():
            updates, self.opt_state = self.optimizer.update(
                grads, self.opt_state, self.params)
            self.params = optim.apply_updates(self.params, updates)
        return fetch_metrics(metrics)

    def get_weights(self):
        return self.params

    def set_weights(self, params) -> bool:
        self.params = to_device(params, self.device)
        return True


class LearnerGroup:
    """One in-process learner (reference: learner_group.py:100 with
    ``num_learners=0``).  ``num_learners >= 1`` raises."""

    def __init__(self, learner_factory: Callable[[], TorchLearner], *,
                 num_learners: int = 0):
        if num_learners != 0:
            raise NotImplementedError(
                f"num_learners={num_learners}: learner actors with a "
                f"gradient allreduce are not ported yet; see "
                f"{PROCESS_TIER}.  Use num_learners=0.")
        self.num_learners = 0
        self.local: TorchLearner = learner_factory()
        self.remotes: list = []

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        return self.local.update(batch)

    def get_weights(self):
        return self.local.get_weights()

    def set_weights(self, params) -> None:
        self.local.set_weights(params)

    def stop(self) -> None:
        pass
