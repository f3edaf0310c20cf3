"""Offline RL: dataset IO + BC / MARWIL / discrete CQL.

Counterpart of ``ray_tpu/rl/offline.py``.  Datasets are ``.npz`` shards
(``save_shard``, ``collect_from_env``, ``OfflineData``: numpy, copied).
The parquet shards and ``Dataset`` inputs the JAX package reads and writes
through ``ray_tpu.data`` (``offline.py:52-75``, ``:178-200``) raise
``NotImplementedError``: they wait for the port's data pipeline (ROADMAP
Queue 1 item 3(c), "data pipeline").

Algorithms:
  * BC      — behavior cloning: max log pi(a|s) (discrete cross-entropy /
              continuous Gaussian log-prob).
  * MARWIL  — advantage-weighted BC: exp(beta * A) weights with a learned
              value baseline (reference: rllib/algorithms/marwil).
  * CQL     — conservative Q-learning (discrete): DQN TD loss +
              alpha * (logsumexp Q - Q(a_data)); its Bellman targets are
              computed on the device and stay there.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ._transfer import fetch, to_device
from .algorithm import Algorithm, AlgorithmConfig
from .env import make_env
from .learner import TorchLearner
from .rl_module import (ContinuousModuleSpec, DiscretePolicyModule,
                        GaussianPolicyModule, QModule, take)

REQUIRED_COLUMNS = ("obs", "actions")
DATA_PIPELINE = ('ROADMAP Queue 1 item 3(c), "data pipeline" (the port has '
                 'no Dataset or parquet IO yet; use .npz shards)')


def save_shard(path: str, columns: Dict[str, np.ndarray]) -> str:
    """Write one columnar ``.npz`` shard."""
    for c in REQUIRED_COLUMNS:
        if c not in columns:
            raise ValueError(f"offline shard missing column {c!r}")
    if not path.endswith(".npz"):
        return save_parquet(path, columns)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **columns)
    return path


def save_parquet(path: str, columns: Dict[str, np.ndarray],
                 shards: int = 4) -> str:
    """Parquet shards through the data pipeline: not ported."""
    raise NotImplementedError(
        f"parquet offline data ({path!r}): see {DATA_PIPELINE}")


def collect_from_env(env_spec: Any, policy_fn, num_steps: int,
                     path: str, *, seed: int = 0,
                     gamma: float = 0.99) -> str:
    """Roll a behavior policy in an env and save the transitions (with
    per-step discounted returns-to-go for MARWIL/CQL targets)."""
    env = make_env(env_spec)
    rng = np.random.default_rng(seed)
    obs, _ = env.reset(seed=seed)
    cols: Dict[str, List] = {k: [] for k in
                             ("obs", "actions", "rewards", "next_obs",
                              "terminateds")}
    ep_start = 0
    returns: List[float] = []
    for t in range(num_steps):
        action = policy_fn(obs, rng)
        next_obs, r, term, trunc, _ = env.step(action)
        cols["obs"].append(obs)
        cols["actions"].append(action)
        cols["rewards"].append(r)
        cols["next_obs"].append(next_obs)
        cols["terminateds"].append(float(term))
        obs = next_obs
        if term or trunc:
            obs, _ = env.reset()
            # Fill discounted returns-to-go for the finished episode.
            ep_rewards = cols["rewards"][ep_start:]
            g = 0.0
            rtg = []
            for rr in reversed(ep_rewards):
                g = rr + gamma * g
                rtg.append(g)
            returns.extend(reversed(rtg))
            ep_start = len(cols["rewards"])
    # Trailing partial episode: bootstrap-free returns-to-go.
    ep_rewards = cols["rewards"][ep_start:]
    g = 0.0
    rtg = []
    for rr in reversed(ep_rewards):
        g = rr + gamma * g
        rtg.append(g)
    returns.extend(reversed(rtg))
    out = {
        "obs": np.asarray(cols["obs"], np.float32),
        "actions": np.asarray(cols["actions"]),
        "rewards": np.asarray(cols["rewards"], np.float32),
        "next_obs": np.asarray(cols["next_obs"], np.float32),
        "terminateds": np.asarray(cols["terminateds"], np.float32),
        "returns_to_go": np.asarray(returns, np.float32),
    }
    return save_shard(path, out)


class OfflineData:
    """Columnar dataset over ``.npz`` shards (a path, a glob or a list of
    paths); uniform minibatches from a seeded numpy generator."""

    def __init__(self, paths, seed: int = 0):
        if isinstance(paths, str):
            expanded = sorted(glob.glob(paths)) if any(
                ch in paths for ch in "*?[") else [paths]
        elif isinstance(paths, (list, tuple)):
            expanded = list(paths)
        else:
            raise NotImplementedError(
                f"offline input {type(paths).__name__}: see "
                f"{DATA_PIPELINE}")
        if not expanded:
            raise ValueError("no offline data shards found")
        if not all(p.endswith(".npz") for p in expanded):
            raise NotImplementedError(
                f"offline input {paths!r} is not .npz: see {DATA_PIPELINE}")
        parts: Dict[str, List[np.ndarray]] = {}
        for p in expanded:
            with np.load(p) as z:
                for k in z.files:
                    parts.setdefault(k, []).append(z[k])
        self.columns = {k: np.concatenate(v) for k, v in parts.items()}
        self.size = len(self.columns["obs"])
        self._rng = np.random.default_rng(seed)

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self.size, batch_size)
        return {k: c[idx] for k, c in self.columns.items()}


# ------------------------------------------------------------------------- #
# BC
# ------------------------------------------------------------------------- #

def bc_discrete_loss(module: DiscretePolicyModule, params, batch):
    out = module.forward_train(params, batch["obs"])
    logp = take(torch.log_softmax(out["action_logits"], -1),
                batch["actions"])
    w = batch.get("bc_weights")
    loss = -torch.mean(w * logp) if w is not None else -torch.mean(logp)
    return loss, {"logp_mean": torch.mean(logp)}


def bc_continuous_loss(module: GaussianPolicyModule, params, batch):
    # Maximize the squashed-Gaussian log-prob of dataset actions by
    # matching the pre-squash mean (stable, standard practice for
    # tanh policies): MSE on the inverse-squashed action + std penalty.
    mean, log_std = module._dist(params, batch["obs"])
    scale, mid = module._scale, module._mid
    squashed = torch.clamp((batch["actions"] - mid) / scale, -0.999, 0.999)
    pre_tanh = torch.atanh(squashed)
    mse = torch.mean(torch.sum((mean - pre_tanh) ** 2, dim=-1))
    std_pen = torch.mean(torch.sum(log_std ** 2, dim=-1))
    return mse + 1e-3 * std_pen, {"bc_mse": mse}


class BCConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(BC)
        self.input_path: Optional[str] = None
        self.train_batch_size = 256
        self.updates_per_iteration = 50

    def offline_data(self, *, input_path: str,
                     updates_per_iteration: Optional[int] = None
                     ) -> "BCConfig":
        self.input_path = input_path
        if updates_per_iteration is not None:
            self.updates_per_iteration = updates_per_iteration
        return self


class BC(Algorithm):
    """Behavior cloning from offline shards (reference:
    rllib/algorithms/bc)."""

    _use_env_runner_group = False
    _loss_fns = (bc_discrete_loss, bc_continuous_loss)

    def setup(self, config: BCConfig) -> None:
        if config.input_path is None:
            raise ValueError("BCConfig.offline_data(input_path=...) required")
        self.data = OfflineData(config.input_path, seed=config.seed)
        env = make_env(config.env_spec)
        self.env = env
        if env.is_continuous:
            spec = ContinuousModuleSpec(
                env.observation_dim, env.action_dim, env.action_low,
                env.action_high, tuple(config.module_hidden))
            self.module = GaussianPolicyModule(spec)
            loss = type(self)._loss_fns[1]
        else:
            self.module = DiscretePolicyModule(config.module_spec())
            loss = type(self)._loss_fns[0]
        self.learner = TorchLearner(self.module, loss,
                                    learning_rate=config.lr,
                                    seed=config.seed, device=self.device)

    def training_step(self) -> Dict[str, Any]:
        cfg: BCConfig = self.config
        metrics: Dict[str, float] = {}
        for _ in range(cfg.updates_per_iteration):
            batch = self.data.sample(cfg.train_batch_size)
            metrics = self.learner.update(self._prepare_batch(batch))
        return {"learner": metrics, "dataset_size": self.data.size}

    def _prepare_batch(self, batch: Dict[str, np.ndarray]):
        return {"obs": batch["obs"], "actions": batch["actions"]}

    @torch.no_grad()
    def compute_single_action(self, obs: np.ndarray):
        a = fetch(self.module.forward_inference(
            self.learner.params, to_device(obs[None], self.device))[0])[0]
        return a if self.env.is_continuous else int(a[0])

    def get_weights(self):
        return self.learner.params

    def set_weights(self, params) -> None:
        self.learner.set_weights(params)


# ------------------------------------------------------------------------- #
# MARWIL (discrete)
# ------------------------------------------------------------------------- #

def marwil_loss(module: DiscretePolicyModule, params, batch):
    out = module.forward_train(params, batch["obs"])
    logp = take(torch.log_softmax(out["action_logits"], -1),
                batch["actions"])
    adv = batch["returns_to_go"] - out["value"]
    vf_loss = torch.mean(adv ** 2)
    beta = batch["beta"][0]
    # exp-advantage weights, gradient-stopped and clipped for stability
    # (reference: marwil.py's c^2 normalization, simplified).  jnp.std is
    # the population std (ddof 0).
    a = adv.detach()
    w = torch.clamp(torch.exp(beta * (a / (torch.std(a, correction=0)
                                           + 1e-6))), 0.0, 20.0)
    pi_loss = -torch.mean(w * logp)
    return pi_loss + 0.5 * vf_loss, {
        "pi_loss": pi_loss, "vf_loss": vf_loss, "w_mean": torch.mean(w)}


class MARWILConfig(BCConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = MARWIL
        self.beta = 1.0

    def training(self, *, beta=None, **kw) -> "MARWILConfig":
        super().training(**kw)
        if beta is not None:
            self.beta = beta
        return self


class MARWIL(BC):
    """Advantage-weighted behavior cloning (reference:
    rllib/algorithms/marwil — beta=0 degenerates to BC)."""

    _loss_fns = (marwil_loss, bc_continuous_loss)

    def setup(self, config: MARWILConfig) -> None:
        super().setup(config)
        if self.env.is_continuous:
            raise ValueError("MARWIL here supports discrete envs; "
                             "use BC/SAC for continuous")
        if "returns_to_go" not in self.data.columns:
            raise ValueError("MARWIL needs returns_to_go in the dataset "
                             "(collect_from_env writes it)")

    def _prepare_batch(self, batch):
        return {"obs": batch["obs"], "actions": batch["actions"],
                "returns_to_go": batch["returns_to_go"],
                "beta": np.array([self.config.beta], np.float32)}


# ------------------------------------------------------------------------- #
# CQL (discrete)
# ------------------------------------------------------------------------- #

def cql_loss(module: QModule, params, batch):
    q = module.q_values(params, batch["obs"])
    q_taken = take(q, batch["actions"])
    td = torch.mean((q_taken - batch["targets"]) ** 2)
    # Conservative penalty: soft-max over all actions minus the data action
    # — pushes down Q for actions the behavior policy never took.
    cql = torch.mean(torch.logsumexp(q, dim=-1) - q_taken)
    alpha = batch["cql_alpha"][0]
    return td + alpha * cql, {"td_loss": td, "cql_penalty": cql,
                              "q_mean": torch.mean(q_taken)}


class CQLConfig(BCConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = CQL
        self.cql_alpha = 1.0
        self.target_update_freq = 10  # in updates

    def training(self, *, cql_alpha=None, target_update_freq=None,
                 **kw) -> "CQLConfig":
        super().training(**kw)
        if cql_alpha is not None:
            self.cql_alpha = cql_alpha
        if target_update_freq is not None:
            self.target_update_freq = target_update_freq
        return self


class CQL(Algorithm):
    """Discrete conservative Q-learning over offline transitions
    (reference: rllib/algorithms/cql; discrete-action form)."""

    _use_env_runner_group = False

    def setup(self, config: CQLConfig) -> None:
        if config.input_path is None:
            raise ValueError("CQLConfig.offline_data(input_path=...) "
                             "required")
        self.data = OfflineData(config.input_path, seed=config.seed)
        for c in ("rewards", "next_obs", "terminateds"):
            if c not in self.data.columns:
                raise ValueError(f"CQL needs transition column {c!r}")
        self.env = make_env(config.env_spec)
        self.module = QModule(config.module_spec())
        self.learner = TorchLearner(self.module, cql_loss,
                                    learning_rate=config.lr,
                                    seed=config.seed, device=self.device)
        self.target_params = self.learner.params
        self._n_updates = 0

    @torch.no_grad()
    def _targets(self, batch) -> torch.Tensor:
        """The Bellman target on the device."""
        b = to_device({k: batch[k] for k in
                       ("next_obs", "rewards", "terminateds")}, self.device)
        q_next = self.module.q_values(self.target_params, b["next_obs"])
        return (b["rewards"] + self.config.gamma * (1.0 - b["terminateds"])
                * q_next.max(-1).values).to(torch.float32)

    def _update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        metrics = self.learner.update({
            "obs": batch["obs"], "actions": batch["actions"],
            "targets": self._targets(batch),
            "cql_alpha": np.array([self.config.cql_alpha], np.float32)})
        self._n_updates += 1
        if self._n_updates % self.config.target_update_freq == 0:
            self.target_params = self.learner.params
        return metrics

    def training_step(self) -> Dict[str, Any]:
        cfg: CQLConfig = self.config
        metrics: Dict[str, float] = {}
        for _ in range(cfg.updates_per_iteration):
            metrics = self._update(self.data.sample(cfg.train_batch_size))
        return {"learner": metrics, "dataset_size": self.data.size}

    @torch.no_grad()
    def compute_single_action(self, obs: np.ndarray) -> int:
        return int(fetch(self.module.forward_inference(
            self.learner.params, to_device(obs[None], self.device)))[0, 0])

    def get_weights(self):
        return self.learner.params

    def set_weights(self, params) -> None:
        self.learner.set_weights(params)
        self.target_params = self.learner.params
