"""PPO: clipped-surrogate policy optimization with GAE.

Counterpart of ``ray_tpu/rl/ppo.py``.  ``compute_gae`` is numpy and
copied; the losses are PyTorch.  ``PPO.training_step`` moves the batch to
the device once and slices its minibatches there, by the same numpy
permutation as the JAX package's (``ppo.py:187-193``), so both packages
given the same rollouts train on the same minibatches.  With learner
actors (``num_learners > 0``) the minibatches are sliced on the host and
split across the learners, as JAX's are, and the env runners take the
learners' weights by ref (``get_weights_ref``).
"""

from __future__ import annotations

import functools
from typing import Any, Dict

import numpy as np
import torch

from ._transfer import to_device
from .algorithm import Algorithm, AlgorithmConfig
from .learner import LearnerGroup, TorchLearner
from .rl_module import DiscretePolicyModule, take


def compute_gae(rewards: np.ndarray, values: np.ndarray, dones: np.ndarray,
                terminateds: np.ndarray, last_values: np.ndarray,
                gamma: float, lam: float,
                bootstrap_values: np.ndarray = None):
    """Generalized Advantage Estimation over time-major [T, N] rollouts.

    ``dones`` marks episode boundaries (no GAE chaining across them).  The
    per-step bootstrap value is:
      * 0 on terminated steps (the future is worth nothing);
      * ``bootstrap_values[t]`` = V(final_obs) on truncated steps — NOT the
        next buffer row, which after auto-reset holds the next episode's
        reset state;
      * V(s_{t+1}) (``values[t+1]`` / ``last_values`` at the end) otherwise.
    """
    T, N = rewards.shape
    if bootstrap_values is None:
        bootstrap_values = np.zeros((T, N), np.float32)
    adv = np.zeros((T, N), np.float32)
    last_gae = np.zeros(N, np.float32)
    next_value = last_values
    for t in reversed(range(T)):
        done = dones[t].astype(np.float32)
        term = terminateds[t].astype(np.float32)
        boundary_value = (1.0 - term) * bootstrap_values[t]
        nv = (1.0 - done) * next_value + done * boundary_value
        delta = rewards[t] + gamma * nv - values[t]
        last_gae = delta + gamma * lam * (1.0 - done) * last_gae
        adv[t] = last_gae
        next_value = values[t]
    returns = adv + values
    return adv, returns


def _clipped_surrogate(logp, batch, out, logp_all):
    ratio = torch.exp(logp - batch["logp_old"])
    adv = batch["advantages"]
    clip = batch["clip_param"][0]
    surrogate = torch.minimum(
        ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
    policy_loss = -torch.mean(surrogate)
    value_loss = torch.mean((out["value"] - batch["value_targets"]) ** 2)
    entropy = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
    total = policy_loss + batch["vf_coeff"][0] * value_loss \
        - batch["ent_coeff"][0] * entropy
    return total, {"policy_loss": policy_loss, "vf_loss": value_loss,
                   "entropy": entropy,
                   "kl": torch.mean(batch["logp_old"] - logp)}


def ppo_loss(module: DiscretePolicyModule, params, batch):
    out = module.forward_train(params, batch["obs"])
    logp_all = torch.log_softmax(out["action_logits"], -1)
    return _clipped_surrogate(take(logp_all, batch["actions"]), batch, out,
                              logp_all)


def ppo_loss_recurrent(module, params, batch):
    """PPO loss over SEQUENCE minibatches for stateful modules: the
    module replays each env's whole rollout window from its recorded
    start state, resetting at in-window episode boundaries."""
    out = module.forward_train(params, batch["obs"], batch["state_in"],
                               batch["resets"])
    logp_all = torch.log_softmax(out["action_logits"], -1)    # [B, T, A]
    return _clipped_surrogate(take(logp_all, batch["actions"]), batch, out,
                              logp_all)


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(PPO)
        self.clip_param = 0.2
        self.lambda_ = 0.95
        self.num_epochs = 4
        self.minibatch_size = 128
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01

    def training(self, *, clip_param=None, lambda_=None, num_epochs=None,
                 minibatch_size=None, vf_loss_coeff=None,
                 entropy_coeff=None, **kw) -> "PPOConfig":
        super().training(**kw)
        if clip_param is not None:
            self.clip_param = clip_param
        if lambda_ is not None:
            self.lambda_ = lambda_
        if num_epochs is not None:
            self.num_epochs = num_epochs
        if minibatch_size is not None:
            self.minibatch_size = minibatch_size
        if vf_loss_coeff is not None:
            self.vf_loss_coeff = vf_loss_coeff
        if entropy_coeff is not None:
            self.entropy_coeff = entropy_coeff
        return self


def _normalized(adv: np.ndarray) -> np.ndarray:
    return ((adv - adv.mean()) / (adv.std() + 1e-8)).astype(np.float32)


def ppo_consts(cfg) -> Dict[str, np.ndarray]:
    return {"clip_param": np.array([cfg.clip_param], np.float32),
            "vf_coeff": np.array([cfg.vf_loss_coeff], np.float32),
            "ent_coeff": np.array([cfg.entropy_coeff], np.float32)}


def minibatch_epochs(update, batch: Dict[str, np.ndarray], consts, rng,
                     num_epochs: int, mb: int, device) -> Dict[str, float]:
    """``num_epochs`` passes over ``batch`` in minibatches of ``mb`` rows,
    each epoch in the order of ``rng.permutation`` (the JAX package's
    loop), the rows gathered on the device."""
    n = len(batch["actions"])
    dev = to_device(batch, device)
    consts = to_device(consts, device)
    metrics: Dict[str, float] = {}
    for _ in range(num_epochs):
        perm = to_device(rng.permutation(n), device)
        for s in range(0, n - mb + 1, mb):
            idx = perm[s:s + mb]
            minibatch = {k: v[idx] for k, v in dev.items()}
            minibatch.update(consts)
            metrics = update(minibatch)
    return metrics


def ppo_learner(spec, lr: float, seed: int, device,
                module_factory=None) -> TorchLearner:
    """PPO's learner (JAX: the ``factory`` closure of ``PPO.setup``), a
    module-level function so learner actors import it by reference."""
    module = module_factory() if module_factory \
        else DiscretePolicyModule(spec)
    loss = ppo_loss_recurrent \
        if hasattr(module, "initial_state") else ppo_loss
    return TorchLearner(module, loss, learning_rate=lr, seed=seed,
                        device=device)


class PPO(Algorithm):
    def setup(self, config: PPOConfig) -> None:
        # Learner actors put their learner on the actor's card: the device
        # they are given is "cuda" (the actor's current card) or the CPU.
        device = self.device if config.num_learners == 0 \
            or self.device.type == "cpu" else "cuda"
        self.learner_group = LearnerGroup(
            functools.partial(ppo_learner, config.module_spec(), config.lr,
                              config.seed, device, config.module_factory),
            num_learners=config.num_learners)
        # Minibatches go to the learners from the host when they are actors.
        self._batch_device = self.device \
            if self.learner_group.local is not None else torch.device("cpu")
        self._rng = np.random.default_rng(config.seed)
        self.env_runner_group.sync_weights(
            self.learner_group.get_weights_ref())

    def training_step(self) -> Dict[str, Any]:
        cfg: PPOConfig = self.config
        rollouts = self.env_runner_group.sample(cfg.rollout_fragment_length)
        if "state_in" in rollouts[0]:
            return self._training_step_recurrent(cfg, rollouts)

        flat: Dict[str, list] = {k: [] for k in
                                 ("obs", "actions", "logp_old",
                                  "advantages", "value_targets")}
        for ro in rollouts:
            adv, ret = compute_gae(ro["rewards"], ro["values"], ro["dones"],
                                   ro["terminateds"], ro["last_values"],
                                   cfg.gamma, cfg.lambda_,
                                   ro.get("bootstrap_values"))
            T, N = ro["rewards"].shape
            flat["obs"].append(ro["obs"].reshape(T * N, -1))
            flat["actions"].append(ro["actions"].reshape(-1))
            flat["logp_old"].append(ro["logp"].reshape(-1))
            flat["advantages"].append(adv.reshape(-1))
            flat["value_targets"].append(ret.reshape(-1))
        batch = {k: np.concatenate(v) for k, v in flat.items()}
        batch["advantages"] = _normalized(batch["advantages"])
        n = len(batch["actions"])
        metrics = minibatch_epochs(
            self.learner_group.update, batch, ppo_consts(cfg), self._rng,
            cfg.num_epochs, min(cfg.minibatch_size, n), self._batch_device)
        self.env_runner_group.sync_weights(
            self.learner_group.get_weights_ref())
        return {"learner": metrics,
                "num_env_steps_sampled": n}

    def _training_step_recurrent(self, cfg: "PPOConfig",
                                 rollouts) -> Dict[str, Any]:
        """Sequence batching for stateful modules: rows are whole
        per-env rollout windows ([B, T] arrays, never shuffled across
        time); the learner replays each from its recorded start state
        with resets at in-window episode boundaries."""
        seq: Dict[str, list] = {k: [] for k in
                                ("obs", "actions", "logp_old",
                                 "advantages", "value_targets",
                                 "state_in", "resets")}
        for ro in rollouts:
            adv, ret = compute_gae(ro["rewards"], ro["values"], ro["dones"],
                                   ro["terminateds"], ro["last_values"],
                                   cfg.gamma, cfg.lambda_,
                                   ro.get("bootstrap_values"))
            dones = np.swapaxes(ro["dones"], 0, 1)         # [N, T]
            resets = np.zeros_like(dones)
            resets[:, 1:] = dones[:, :-1]
            seq["obs"].append(np.swapaxes(ro["obs"], 0, 1))
            seq["actions"].append(np.swapaxes(ro["actions"], 0, 1))
            seq["logp_old"].append(np.swapaxes(ro["logp"], 0, 1))
            seq["advantages"].append(np.swapaxes(adv, 0, 1))
            seq["value_targets"].append(np.swapaxes(ret, 0, 1))
            seq["state_in"].append(ro["state_in"])
            seq["resets"].append(resets)
        batch = {k: np.concatenate(v) for k, v in seq.items()}
        batch["advantages"] = _normalized(batch["advantages"])
        n_rows, T = batch["actions"].shape
        mb_rows = max(1, min(n_rows, cfg.minibatch_size // max(T, 1)))
        metrics = minibatch_epochs(
            self.learner_group.update, batch, ppo_consts(cfg), self._rng,
            cfg.num_epochs, mb_rows, self._batch_device)
        self.env_runner_group.sync_weights(
            self.learner_group.get_weights_ref())
        return {"learner": metrics,
                "num_env_steps_sampled": n_rows * T}

    def get_weights(self):
        return self.learner_group.get_weights()

    def set_weights(self, params) -> None:
        self.learner_group.set_weights(params)

    def stop(self) -> None:
        super().stop()
        self.learner_group.stop()
