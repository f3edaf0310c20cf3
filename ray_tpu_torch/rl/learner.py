"""Learning layer: TorchLearner + LearnerGroup.

Counterpart of ``ray_tpu/rl/learner.py`` (``JaxLearner`` ->
``TorchLearner``).  One update is the JAX learner's jitted ``grad_step``:
the loss, its gradients (``torch.autograd.grad`` over the params' leaves),
``optim.chain(clip_by_global_norm, adam)`` exactly as optax computes it,
and new params; the metrics dict comes back to the host in ONE transfer
(``ray_tpu/rl/learner.py:74-83``).  Params are never written in place: a
tree handed out by ``get_weights`` stays a snapshot, as a JAX array does.

``LearnerGroup`` runs one in-process learner (``num_learners=0``) or
``num_learners`` learner actors (``ray_tpu_torch._actor``), each holding
its learner on the actor's device.  With two or more they form a gloo
collective group and update DDP-style: each computes its shard's gradients,
the flat gradients are summed by ``collective.allreduce`` over host arrays
and divided by the world size, and every replica applies the same mean, so
the replicas stay bit-identical (one card: NCCL refuses two ranks on one
device, so the host allreduce is JAX's too).  If the group does not form,
this process averages the gradients instead.  The learner factory travels to
the actors by pickle: a module-level function or a ``functools.partial``
of one.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import _actor, optim
from .._device import DeviceLike, make_generator, resolve_device
from .._tree import tree_leaves, tree_map, tree_unflatten
from ._transfer import fetch_metrics, to_device, to_numpy


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

    # -- distributed path ------------------------------------------------- #

    def compute_gradients(self, batch) -> Tuple[Any, Dict[str, float]]:
        """The gradients of ``batch``'s loss (no update) and its metrics,
        the metrics in one transfer."""
        batch = to_device(batch, self.device)
        (loss, metrics), grads = value_and_grad(
            lambda p: self.loss_fn(self.module, p, batch), self.params)
        metrics = _detach(dict(metrics))
        metrics["loss"] = loss.detach()
        return grads, fetch_metrics(metrics)

    def apply_gradients(self, grads) -> bool:
        """One optimizer step with ``grads`` (tensors or numpy)."""
        grads = to_device(grads, self.device)
        with torch.no_grad():
            updates, self.opt_state = self.optimizer.update(
                grads, self.opt_state, self.params)
            self.params = optim.apply_updates(self.params, updates)
        return True

    def get_weights(self):
        return self.params

    def set_weights(self, params) -> bool:
        self.params = to_device(params, self.device)
        return True


class LearnerActor:
    """One learner in its own process (JAX: ``LearnerGroup``'s nested
    ``LearnerActor``).  Trees leave it as numpy."""

    def __init__(self, factory: Callable[[], TorchLearner]):
        self._factory = factory
        self.learner = None
        self._ddp_group = None

    def setup_ddp(self, world_size: int, rank: int, group_name: str,
                  backend: str = "xla") -> bool:
        """Join the learner allreduce group (reference:
        learner_group.py:187 DDP setup), before the learner builds as
        JAX's does."""
        from .. import collective
        collective.init_collective_group(world_size, rank, backend=backend,
                                         group_name=group_name)
        self._ddp_group = group_name
        return True

    def build(self) -> bool:
        if self.learner is None:
            self.learner = self._factory()
        return True

    def update_ddp(self, batch) -> Dict[str, float]:
        """Grad step with gradients averaged across the learner group by
        allreduce: gradients never leave the actors."""
        from .. import collective
        grads, metrics = self.learner.compute_gradients(batch)
        leaves = tree_leaves(grads)
        flat = torch.cat([g.reshape(-1) for g in leaves]).cpu().numpy()
        summed = collective.allreduce(flat, group_name=self._ddp_group)
        world = collective.get_collective_group_size(self._ddp_group)
        mean = torch.from_numpy(summed / np.float32(world))
        parts = torch.split(mean, [g.numel() for g in leaves])
        self.learner.apply_gradients(tree_unflatten(grads, [
            p.reshape(g.shape).to(g.dtype) for p, g in zip(parts, leaves)]))
        return metrics

    def compute_gradients(self, batch):
        grads, metrics = self.learner.compute_gradients(batch)
        return to_numpy(grads), metrics

    def apply_gradients(self, grads) -> bool:
        return self.learner.apply_gradients(grads)

    def update(self, batch) -> Dict[str, float]:
        return self.learner.update(batch)

    def get_weights(self):
        return to_numpy(self.learner.get_weights())

    def set_weights(self, params) -> bool:
        return self.learner.set_weights(params)


class LearnerGroup:
    """1..N data-parallel learners (reference: learner_group.py:100).

    ``num_learners=0``: a single in-process learner (fast path / tests).
    ``num_learners>=1``: learner actors; each computes gradients on its
    shard, the group averages and applies everywhere, keeping replicas
    bit-identical (the reference's DDP contract).  ``learner_resources``:
    extra actor options for each learner (JAX: the actors' ``resources``),
    e.g. ``{"device": "cuda:1"}``.
    """

    def __init__(self, learner_factory: Callable[[], TorchLearner], *,
                 num_learners: int = 0,
                 learner_resources: Optional[Dict[str, Any]] = None):
        self.num_learners = num_learners
        self._ddp = False
        if num_learners == 0:
            self.local: Optional[TorchLearner] = learner_factory()
            self.remotes: list = []
            return
        self.local = None
        cls = _actor.remote(LearnerActor)
        opts = dict({"num_cpus": 1}, **(learner_resources or {}))
        self.remotes = [cls.options(**opts).remote(learner_factory)
                        for _ in range(num_learners)]
        if num_learners >= 2:
            import os
            group = f"learner_ddp_{os.getpid()}_{id(self):x}"
            try:
                _actor.get([r.setup_ddp.remote(num_learners, i, group)
                            for i, r in enumerate(self.remotes)],
                           timeout=120)
                self._ddp = True
            except Exception:  # noqa: BLE001 - JAX's fallback, kept
                # The collective group could not form: this process averages
                # the gradients instead.
                pass
        _actor.get([r.build.remote() for r in self.remotes])
        # Align initial weights to replica 0 so gradient averaging keeps
        # them identical forever after.
        w0 = _actor.get(self.remotes[0].get_weights.remote())
        _actor.get([r.set_weights.remote(w0) for r in self.remotes[1:]])

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        if self.local is not None:
            return self.local.update(batch)
        shards = _split_batch(batch, len(self.remotes))
        if self._ddp:
            # Gradients allreduce among the learner actors; this process
            # only sees metrics (reference: DDP across learner workers).
            metrics_list = _actor.get([
                r.update_ddp.remote(s)
                for r, s in zip(self.remotes, shards)])
        else:
            outs = _actor.get([r.compute_gradients.remote(s)
                               for r, s in zip(self.remotes, shards)])
            grads = [g for g, _ in outs]
            mean_grads = tree_map(lambda *gs: sum(gs) / len(gs), *grads)
            _actor.get([r.apply_gradients.remote(mean_grads)
                        for r in self.remotes])
            metrics_list = [m for _, m in outs]
        return {k: float(np.mean([m[k] for m in metrics_list]))
                for k in metrics_list[0]}

    def get_weights(self):
        if self.local is not None:
            return self.local.get_weights()
        return _actor.get(self.remotes[0].get_weights.remote())

    def get_weights_ref(self):
        """Remote mode: replica 0's weights as an ObjectRef, which the env
        runners' calls resolve; local mode: the weights."""
        if self.local is not None:
            return self.local.get_weights()
        return self.remotes[0].get_weights.remote()

    def set_weights(self, params) -> None:
        if self.local is not None:
            self.local.set_weights(params)
            return
        params = to_numpy(params)
        _actor.get([r.set_weights.remote(params) for r in self.remotes])

    def stop(self) -> None:
        for r in self.remotes:
            _actor.kill(r)


def _split_batch(batch: Dict[str, Any], n: int
                 ) -> List[Dict[str, np.ndarray]]:
    shards: List[Dict[str, np.ndarray]] = [{} for _ in range(n)]
    for k, v in batch.items():
        v = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        if len(v) == 1:
            # Broadcast scalars/constants (e.g. loss coefficients) to every
            # learner instead of splitting them.
            for i in range(n):
                shards[i][k] = v
            continue
        parts = np.array_split(v, n)
        if min(len(p) for p in parts) == 0:
            raise ValueError(
                f"batch axis of {k!r} ({len(v)}) too small to split across "
                f"{n} learners")
        for i, p in enumerate(parts):
            shards[i][k] = p
    return shards
