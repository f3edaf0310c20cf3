"""IMPALA and APPO with V-trace off-policy correction.

Counterpart of ``ray_tpu/rl/impala.py``.  ``vtrace`` is numpy and copied;
the losses are PyTorch.  With remote runners (the default config's 2,
``impala.py:112``) sampling overlaps learning: one sample is in flight per
runner, the learner takes whichever finishes first (``wait``), and the
stale rollouts are V-trace-corrected (``impala.py:185-251``).  With
``num_env_runners=0`` it is the JAX package's synchronous
A2C-with-V-trace mode.

The learner's forward over a rollout (current-policy log-probs and values
for V-trace) comes back to the host in one transfer.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .. import _actor
from ._transfer import fetch, to_device, to_numpy
from .algorithm import Algorithm, AlgorithmConfig
from .learner import TorchLearner
from .rl_module import DiscretePolicyModule, take


def vtrace(behavior_logp: np.ndarray, target_logp: np.ndarray,
           rewards: np.ndarray, values: np.ndarray, dones: np.ndarray,
           terminateds: np.ndarray, bootstrap_values: np.ndarray,
           last_values: np.ndarray, gamma: float,
           rho_clip: float = 1.0, c_clip: float = 1.0):
    """V-trace targets + policy-gradient advantages over [T, N] rollouts.

    ``values`` must be the *current* (learner) policy's value estimates of
    the rollout observations; ``behavior_logp`` is the logp recorded at
    sampling time.  Episode boundaries (``dones``) stop the vs recursion;
    terminated steps bootstrap 0, truncated steps bootstrap
    ``bootstrap_values[t]`` (V(final_obs) under the current policy is
    approximated by the sampler's estimate — consistent with how the
    runner records it).
    """
    T, N = rewards.shape
    rho = np.minimum(np.exp(target_logp - behavior_logp), rho_clip)
    c = np.minimum(np.exp(target_logp - behavior_logp), c_clip)
    vs = np.zeros((T, N), np.float32)
    vs_next = last_values.astype(np.float32)
    v_next = last_values.astype(np.float32)
    for t in reversed(range(T)):
        done = dones[t].astype(np.float32)
        term = terminateds[t].astype(np.float32)
        boundary_v = (1.0 - term) * bootstrap_values[t]
        v_tp1 = (1.0 - done) * v_next + done * boundary_v
        vs_tp1 = (1.0 - done) * vs_next + done * boundary_v
        delta = rho[t] * (rewards[t] + gamma * v_tp1 - values[t])
        vs[t] = values[t] + delta + gamma * c[t] * (1.0 - done) * \
            (vs_next - v_next)
        vs_next = vs[t]
        v_next = values[t]
    # PG advantage: rho * (r + gamma * vs_{t+1} - V(x_t))
    vs_tp1_full = np.zeros((T, N), np.float32)
    vs_tp1_full[:-1] = vs[1:]
    vs_tp1_full[-1] = last_values
    done_f = dones.astype(np.float32)
    term_f = terminateds.astype(np.float32)
    boundary = (1.0 - term_f) * bootstrap_values
    vs_tp1_full = (1.0 - done_f) * vs_tp1_full + done_f * boundary
    pg_adv = rho * (rewards + gamma * vs_tp1_full - values)
    return vs, pg_adv.astype(np.float32)


def _vf_and_entropy(module, params, batch):
    out = module.forward_train(params, batch["obs"])
    logp_all = torch.log_softmax(out["action_logits"], -1)
    vf_loss = torch.mean((out["value"] - batch["vs_targets"]) ** 2)
    entropy = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
    return take(logp_all, batch["actions"]), vf_loss, entropy


def impala_loss(module: DiscretePolicyModule, params, batch):
    logp, vf_loss, entropy = _vf_and_entropy(module, params, batch)
    pg_loss = -torch.mean(logp * batch["pg_advantages"])
    total = pg_loss + batch["vf_coeff"][0] * vf_loss \
        - batch["ent_coeff"][0] * entropy
    return total, {"pg_loss": pg_loss, "vf_loss": vf_loss,
                   "entropy": entropy}


def appo_loss(module: DiscretePolicyModule, params, batch):
    """Clipped-surrogate variant over V-trace advantages (reference:
    rllib/algorithms/appo — PPO's ratio clip applied to IMPALA's
    pipeline)."""
    logp, vf_loss, entropy = _vf_and_entropy(module, params, batch)
    ratio = torch.exp(logp - batch["behavior_logp"])
    adv = batch["pg_advantages"]
    clip = batch["clip_param"][0]
    surrogate = torch.minimum(
        ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
    pg_loss = -torch.mean(surrogate)
    total = pg_loss + batch["vf_coeff"][0] * vf_loss \
        - batch["ent_coeff"][0] * entropy
    return total, {"pg_loss": pg_loss, "vf_loss": vf_loss,
                   "entropy": entropy}


class IMPALAConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(IMPALA)
        self.num_env_runners = 2       # async needs remote runners
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.rho_clip = 1.0
        self.c_clip = 1.0
        self.batches_per_iteration = 4

    def training(self, *, vf_loss_coeff=None, entropy_coeff=None,
                 rho_clip=None, c_clip=None, batches_per_iteration=None,
                 **kw) -> "IMPALAConfig":
        super().training(**kw)
        for name, val in (("vf_loss_coeff", vf_loss_coeff),
                          ("entropy_coeff", entropy_coeff),
                          ("rho_clip", rho_clip), ("c_clip", c_clip),
                          ("batches_per_iteration", batches_per_iteration)):
            if val is not None:
                setattr(self, name, val)
        return self


class IMPALA(Algorithm):
    """Async actor-critic (reference: rllib/algorithms/impala).

    With ``num_env_runners=0`` it degrades to synchronous A2C-with-vtrace
    (useful for deterministic tests); with remote runners, sampling
    overlaps learning and stale rollouts are V-trace-corrected.
    """

    _loss_fn = staticmethod(impala_loss)

    def setup(self, config: IMPALAConfig) -> None:
        spec = config.module_spec()
        self.module = DiscretePolicyModule(spec)
        self.learner = TorchLearner(self.module, type(self)._loss_fn,
                                    learning_rate=config.lr,
                                    seed=config.seed, device=self.device)
        self.env_runner_group.sync_weights(self.learner.params)
        # In-flight sample refs per remote runner (async pipeline).
        self._inflight: Dict[Any, Any] = {}
        self._steps_sampled = 0

    def _correct_and_update(self, rollout: Dict[str, np.ndarray]
                            ) -> Dict[str, float]:
        cfg: IMPALAConfig = self.config
        T, N = rollout["rewards"].shape
        obs_flat = rollout["obs"].reshape(T * N, -1)
        actions_flat = rollout["actions"].reshape(-1)
        with torch.no_grad():
            out = self.module.forward_train(
                self.learner.params, to_device(obs_flat, self.device))
            target_logp, cur_values = fetch(
                take(torch.log_softmax(out["action_logits"], -1),
                     to_device(actions_flat, self.device)), out["value"])
        vs, pg_adv = vtrace(
            rollout["logp"], target_logp.reshape(T, N), rollout["rewards"],
            cur_values.reshape(T, N), rollout["dones"],
            rollout["terminateds"], rollout["bootstrap_values"],
            rollout["last_values"], cfg.gamma, cfg.rho_clip, cfg.c_clip)
        batch = {
            "obs": obs_flat,
            "actions": actions_flat.astype(np.int32),
            "pg_advantages": pg_adv.reshape(-1),
            "vs_targets": vs.reshape(-1),
            "behavior_logp": rollout["logp"].reshape(-1),
            "vf_coeff": np.array([cfg.vf_loss_coeff], np.float32),
            "ent_coeff": np.array([cfg.entropy_coeff], np.float32),
            "clip_param": np.array(
                [getattr(cfg, "clip_param", 0.0)], np.float32),
        }
        self._steps_sampled += T * N
        return self.learner.update(batch)

    def training_step(self) -> Dict[str, Any]:
        cfg: IMPALAConfig = self.config
        group = self.env_runner_group
        metrics: Dict[str, float] = {}
        if not group.remotes:
            # Synchronous fallback: local runner, still vtrace-corrected.
            for _ in range(cfg.batches_per_iteration):
                rollout = group.sample(cfg.rollout_fragment_length)[0]
                metrics = self._correct_and_update(rollout)
                group.sync_weights(self.learner.params)
            return {"learner": metrics,
                    "num_env_steps_sampled": self._steps_sampled}
        # Async: keep one sample in flight per runner; consume as ready.
        for r in group.remotes:
            if r not in self._inflight:
                self._inflight[r] = r.sample.remote(
                    cfg.rollout_fragment_length)
        consumed = 0
        while consumed < cfg.batches_per_iteration:
            refs = list(self._inflight.values())
            ready, _ = _actor.wait(refs, num_returns=1, timeout=60)
            if not ready:
                break
            runner = next(r for r, ref in self._inflight.items()
                          if ref is ready[0])
            metrics = self._correct_and_update(_actor.get(ready[0]))
            # Fresh weights to the runner that just finished, then relaunch
            # (the other runners keep sampling with slightly stale policy:
            # that lag is exactly what V-trace corrects).
            _actor.get(runner.set_state.remote(
                {"params": to_numpy(self.learner.params)}))
            self._inflight[runner] = runner.sample.remote(
                cfg.rollout_fragment_length)
            consumed += 1
        return {"learner": metrics,
                "num_env_steps_sampled": self._steps_sampled}

    def get_weights(self):
        return self.learner.params

    def set_weights(self, params) -> None:
        self.learner.set_weights(params)
        self.env_runner_group.sync_weights(self.learner.params)

    def stop(self) -> None:
        self._inflight.clear()
        super().stop()


class APPOConfig(IMPALAConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = APPO
        self.clip_param = 0.2

    def training(self, *, clip_param=None, **kw) -> "APPOConfig":
        super().training(**kw)
        if clip_param is not None:
            self.clip_param = clip_param
        return self


class APPO(IMPALA):
    """PPO's clipped-surrogate policy loss over IMPALA's V-trace
    advantages (reference: rllib/algorithms/appo)."""

    _loss_fn = staticmethod(appo_loss)
