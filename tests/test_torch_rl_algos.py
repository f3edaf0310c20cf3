"""The port's RL algorithms against the JAX package's, on the CPU: one
update (or one whole ``training_step``) of each from the same weights,
optimizer state and batch; the device-resident CartPole against the numpy
env; checkpoints and weights across the two packages; what the port
refuses.

Where both packages draw the same numpy streams (PPO's minibatch
permutation, the replay and offline samplers, DQN's epsilon-greedy coin)
a whole ``training_step`` is compared; where JAX draws with ``jax.random``
(SAC's and TQC's normals) the test rebuilds JAX's draws from its key and
hands them to the port's update.  Rollouts are made once and fed to both.

Tolerance: fp32 1e-5, params and optimizer state relative to the largest
magnitude in their tree (``tests/test_torch_rl.py`` says why).
"""

from __future__ import annotations

import os

import numpy as np
import pytest

import jax
import torch

import ray_tpu.rl as jrl
import ray_tpu_torch.rl as trl
from ray_tpu_torch.models import convert
from ray_tpu_torch.rl import env_runner as t_env_runner
from ray_tpu_torch.rl.torch_env import TorchCartPoleVector

from _torch_rl import one_thread  # noqa: F401  (autouse)
from _torch_rl import CPU, close, rng, trees_close


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _same_start(j_algo, t_algo):
    """The port's algorithm onto the JAX one's weights (fresh optimizer
    states are zeros in both)."""
    t_algo.set_weights(_np_tree(j_algo.get_weights()))


def _guess_rollout(seed=0, T=16, N=4, obs_dim=4, n_act=4):
    r = rng(seed)
    dones = r.random((T, N)) < 0.3
    terms = dones & (r.random((T, N)) < 0.7)
    return {"obs": r.normal(size=(T, N, obs_dim)).astype(np.float32),
            "actions": r.integers(0, n_act, (T, N)).astype(np.int32),
            "logp": np.log(r.uniform(0.1, 0.5, (T, N))).astype(np.float32),
            "values": r.normal(size=(T, N)).astype(np.float32),
            "rewards": r.normal(size=(T, N)).astype(np.float32),
            "dones": dones, "terminateds": terms,
            "bootstrap_values": np.where(dones & ~terms, r.normal(
                size=(T, N)), 0).astype(np.float32),
            "last_values": r.normal(size=N).astype(np.float32)}


# ------------------------------------------------------------------- PPO

def _ppo_pair(cfg_fn):
    j = cfg_fn(jrl.PPOConfig()).build_algo()
    t = cfg_fn(trl.PPOConfig()).resources(device=CPU).build_algo()
    _same_start(j, t)
    return j, t


def test_ppo_training_step_on_identical_rollouts():
    """A whole training_step (GAE, normalisation, 4 epochs x 4
    minibatches of the same numpy permutation): params within 1e-5."""
    cfg = lambda c: (c.environment(lambda: jrl.StatelessGuess(4))
                     .env_runners(num_envs_per_env_runner=4,
                                  rollout_fragment_length=16)
                     .training(minibatch_size=16, lr=1e-3).debugging(seed=3))
    j, t = _ppo_pair(cfg)
    for it in range(2):
        ro = _guess_rollout(seed=it)
        j.env_runner_group.sample = lambda n, ro=ro: [ro]
        t.env_runner_group.sample = lambda n, ro=ro: [ro]
        jm, tm = j.training_step(), t.training_step()
        for k in jm["learner"]:
            close(tm["learner"][k], jm["learner"][k], what=k)
        trees_close(t.get_weights(), j.get_weights(), whole_tree=True,
                    what="params")
        # The runner got the new weights.
        trees_close(t.env_runner_group.local.params, j.get_weights(),
                    whole_tree=True, what="runner")


def test_recurrent_ppo_training_step_on_identical_rollouts():
    def cfg(c, mods):
        return (c.environment(lambda: jrl.env.DelayedRecall(delay=3))
                .env_runners(num_envs_per_env_runner=4,
                             rollout_fragment_length=8)
                .training(minibatch_size=16, num_epochs=2, lr=1e-3)
                .rl_module(module_factory=lambda: mods.GRUPolicyModule(
                    mods.RecurrentPolicySpec(obs_dim=3, num_actions=2,
                                             hidden=8, embed=(16,)))))
    j = cfg(jrl.PPOConfig(), jrl).build_algo()
    t = cfg(trl.PPOConfig(), trl).resources(device=CPU).build_algo()
    _same_start(j, t)
    ro = _guess_rollout(T=8, obs_dim=3, n_act=2)
    ro["state_in"] = rng(9).normal(size=(4, 8)).astype(np.float32)
    j.env_runner_group.sample = lambda n: [ro]
    t.env_runner_group.sample = lambda n: [ro]
    j.training_step()
    t.training_step()
    trees_close(t.get_weights(), j.get_weights(), whole_tree=True)


def test_env_runner_one_transfer_per_step(monkeypatch):
    """One device -> host read a step, plus one at the end of a sample for
    the bootstrap values (no truncation in 12 CartPole steps)."""
    calls = []
    real = t_env_runner.fetch
    monkeypatch.setattr(t_env_runner, "fetch",
                        lambda *v: calls.append(len(v)) or real(*v))
    runner = trl.EnvRunner(trl.CartPole, num_envs=3, seed=0, device=CPU)
    batch = runner.sample(12)
    assert calls == [3] * 12 + [1]
    assert batch["obs"].shape == (12, 3, 4)
    assert batch["actions"].dtype == np.int32


def test_cross_restore_ppo_both_ways(tmp_path):
    """The port's checkpoint restores into JAX's PPO and JAX's into the
    port's; after each, greedy actions are equal."""
    obs = rng(4).normal(size=(256, 4)).astype(np.float32)
    j = jrl.PPOConfig().environment("CartPole-v1").env_runners(
        rollout_fragment_length=16).build_algo()
    t = trl.PPOConfig().environment("CartPole-v1").env_runners(
        rollout_fragment_length=16).resources(device=CPU).build_algo()
    j.train()
    t.train()

    def greedy_j(algo):
        mod = algo.learner_group.local.module
        return np.asarray(mod.forward_inference(algo.get_weights(), obs))

    def greedy_t(algo):
        mod = algo.learner_group.local.module
        return mod.forward_inference(algo.get_weights(),
                                     torch.from_numpy(obs)).numpy()

    j2 = jrl.PPOConfig().environment("CartPole-v1").build_algo()
    j2.restore(t.save(str(tmp_path / "port")))
    assert j2.iteration == 1
    np.testing.assert_array_equal(greedy_j(j2), greedy_t(t))
    t2 = trl.PPOConfig().environment("CartPole-v1").resources(
        device=CPU).build_algo()
    t2.restore(j.save(str(tmp_path / "jax")))
    np.testing.assert_array_equal(greedy_t(t2), greedy_j(j))
    trees_close(t2.env_runner_group.local.params, j.get_weights(), tol=0)


# ------------------------------------------------------- DQN, SAC, TQC

@pytest.mark.parametrize("double_q,prioritized", [(True, False),
                                                  (False, True)])
def test_dqn_training_step(double_q, prioritized):
    """A whole training_step (48 env steps, 33 updates, a target sync at
    step 40): the same epsilon coins and replay samples (numpy), the same
    greedy actions, the same TD targets and updates.  One step, not more:
    a second drives the loss to ~2e-4, where Adam's normalised steps turn
    last-bit gradient differences into 1e-4 of the loss."""
    def cfg(c):
        return (c.environment(lambda: jrl.StatelessGuess(3))
                .env_runners(rollout_fragment_length=48)
                .training(lr=1e-3, learning_starts=16, train_batch_size=8,
                          target_update_freq=20, double_q=double_q,
                          prioritized_replay=prioritized,
                          epsilon_decay_steps=64).debugging(seed=1))
    j = cfg(jrl.DQNConfig()).build_algo()
    t = cfg(trl.DQNConfig()).resources(device=CPU).build_algo()
    _same_start(j, t)
    jm, tm = j.training_step(), t.training_step()
    for k in jm["learner"]:
        close(tm["learner"][k], jm["learner"][k], what=k)
    assert tm["buffer_size"] == jm["buffer_size"] == 48
    trees_close(t.get_weights(), j.get_weights(), whole_tree=True)
    trees_close(t.target_params, j.target_params, whole_tree=True)
    if prioritized:
        n = len(j.buffer)
        # (|td| + eps) ** 0.6 of TD errors ~1e-3 that are differences of
        # Q values ~1: absolute, 1e-5 of the Q scale.
        np.testing.assert_allclose(t.buffer._prio[:n], j.buffer._prio[:n],
                                   rtol=0, atol=1e-5)


def _continuous_pair(jcfg, tcfg, hidden=(32, 32)):
    mk = lambda c: (c.environment("TargetReach").training(lr=1e-3)
                    .rl_module(hidden=hidden).debugging(seed=2))
    j = mk(jcfg).build_algo()
    t = mk(tcfg).resources(device=CPU).build_algo()
    _same_start(j, t)
    return j, t


def _continuous_batch(seed, B=32):
    r = rng(seed)
    return {"obs": r.uniform(-0.8, 0.8, (B, 1)).astype(np.float32),
            "actions": r.uniform(-1, 1, (B, 1)).astype(np.float32),
            "rewards": r.normal(size=B).astype(np.float32),
            "next_obs": r.uniform(-0.8, 0.8, (B, 1)).astype(np.float32),
            "terminateds": (r.random(B) < 0.5).astype(np.float32)}


@pytest.mark.parametrize("algo", ["sac", "tqc"])
def test_sac_and_tqc_update_with_jax_draws(algo):
    """Two updates; each update's normals rebuilt from JAX's key
    (``k1, k2 = split(key)``, ``normal(k, (B, action_dim))``)."""
    if algo == "sac":
        j, t = _continuous_pair(jrl.SACConfig(), trl.SACConfig())
    else:
        j, t = _continuous_pair(
            jrl.TQCConfig().training(num_critics=2, num_quantiles=5,
                                     top_quantiles_to_drop=1),
            trl.TQCConfig().training(num_critics=2, num_quantiles=5,
                                     top_quantiles_to_drop=1))
    for i in range(2):
        batch = _continuous_batch(i)
        key = jax.random.key(100 + i)
        k1, k2 = jax.random.split(key)
        eps = tuple(np.asarray(jax.random.normal(k, (32, 1)))
                    for k in (k1, k2))
        j.state, jm = j._update(j.state, batch, key)
        tm = t._update(batch, eps=eps)
        assert sorted(jm) == sorted(tm)
        for k in jm:
            # z_mean averages signed quantiles of ~0.1 down to ~4e-4:
            # held relative to 0.1.
            close(tm[k], jm[k], what=k, floor=0.1 if k == "z_mean" else 0)
    trees_close(t.state, j.state, whole_tree=True, what="state")


def test_sac_cross_restore(tmp_path):
    j, t = _continuous_pair(jrl.SACConfig(), trl.SACConfig())
    t._update(_continuous_batch(5))
    j2 = jrl.SACConfig().environment("TargetReach").rl_module(
        hidden=(32, 32)).build_algo()
    j2.restore(t.save(str(tmp_path / "ck")))
    for x in np.linspace(-0.8, 0.8, 5):
        o = np.array([x], np.float32)
        close(t.compute_single_action(o), j2.compute_single_action(o))


# ----------------------------------------------------------- IMPALA/APPO

@pytest.mark.parametrize("name", ["IMPALA", "APPO"])
def test_impala_appo_correct_and_update(name):
    def cfg(c):
        return (c.environment(lambda: jrl.StatelessGuess(4))
                .env_runners(num_env_runners=0, rollout_fragment_length=16)
                .training(lr=1e-3).debugging(seed=4))
    j = cfg(getattr(jrl, name + "Config")()).build_algo()
    t = cfg(getattr(trl, name + "Config")()).resources(
        device=CPU).build_algo()
    _same_start(j, t)
    for i in range(2):
        ro = _guess_rollout(seed=10 + i)
        jm = j._correct_and_update(ro)
        tm = t._correct_and_update(ro)
        for k in jm:
            close(tm[k], jm[k], what=k)
    trees_close(t.get_weights(), j.get_weights(), whole_tree=True)


def test_impala_default_config_refuses():
    """The JAX default is 2 remote runners (async), which the port runs
    (tests/test_torch_rl_remote.py); it refuses an env given as a lambda,
    as JAX's tests give it (tests/test_rl.py:171), naming the
    by-reference rule."""
    with pytest.raises(ValueError, match="top level of a module"):
        trl.IMPALAConfig().environment(
            lambda: trl.StatelessGuess(2)).resources(device=CPU).build_algo()


# ---------------------------------------------------------------- offline

@pytest.fixture(scope="module")
def guess_data(tmp_path_factory):
    def behavior(obs, r):
        return int(r.integers(4)) if r.random() < 0.3 \
            else int(np.argmax(obs))
    path = os.path.join(str(tmp_path_factory.mktemp("offline")),
                        "shard-0.npz")
    return trl.collect_from_env("StatelessGuess", behavior, 600, path,
                                seed=0)


@pytest.mark.parametrize("name", ["BC", "MARWIL", "CQL", "IQL"])
def test_offline_training_step(guess_data, name):
    """A whole training_step of 3 updates (the same numpy minibatches;
    CQL and IQL refresh their targets after the 2nd)."""
    def cfg(c):
        c = (c.environment("StatelessGuess")
             .offline_data(input_path=guess_data, updates_per_iteration=3)
             .training(lr=1e-3).debugging(seed=5))
        if name in ("CQL", "IQL"):
            c = c.training(target_update_freq=2)
        return c
    j = cfg(getattr(jrl, name + "Config")()).build_algo()
    t = cfg(getattr(trl, name + "Config")()).resources(
        device=CPU).build_algo()
    _same_start(j, t)
    jm, tm = j.training_step(), t.training_step()
    for k in jm["learner"]:
        close(tm["learner"][k], jm["learner"][k], what=k)
    trees_close(t.get_weights(), j.get_weights(), whole_tree=True)
    obs = np.eye(4, dtype=np.float32)
    assert [t.compute_single_action(o) for o in obs] == \
        [j.compute_single_action(o) for o in obs]


def test_offline_refuses_parquet_and_datasets(tmp_path):
    """What ``OfflineData`` still refuses, with the same errors in both
    packages: a directory that holds no parquet shards, a glob that
    matches nothing, and a ``Dataset`` without rows."""
    import ray_tpu.data as jdata
    from ray_tpu_torch import data as tdata
    (tmp_path / "empty").mkdir()
    for rl, data in ((jrl, jdata), (trl, tdata)):
        for src, msg in (
                (str(tmp_path / "empty"), "no parquet shards under"),
                (str(tmp_path / "nothing*"), "no offline data shards found"),
                (data.from_numpy({"obs": np.zeros((0, 2), np.float32),
                                  "actions": np.zeros(0)}),
                 "offline dataset is empty")):
            with pytest.raises(ValueError, match=msg):
                rl.OfflineData(src)


def test_offline_reads_parquet_and_datasets(tmp_path, guess_data):
    """Parquet shards and ``Dataset`` inputs read back what was written,
    as JAX's do."""
    from ray_tpu_torch import data as tdata
    cols = {"obs": np.arange(8, dtype=np.float32).reshape(4, 2),
            "actions": np.arange(4)}
    trl.save_shard(str(tmp_path / "episodes"), cols)
    trl.save_parquet(str(tmp_path / "more"), cols)
    for src in (str(tmp_path / "episodes"), str(tmp_path / "more"),
                tdata.from_numpy(cols, parallelism=2)):
        got = trl.OfflineData(src).columns
        assert sorted(got) == ["actions", "obs"]
        np.testing.assert_array_equal(got["obs"], cols["obs"])
        np.testing.assert_array_equal(got["actions"], cols["actions"])
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="no parquet shards"):
        trl.OfflineData(str(tmp_path / "empty"))
    assert trl.OfflineData([guess_data, guess_data]).size == 1200


# ------------------------------------------------------------ multi-agent

@pytest.mark.parametrize("mapping", ["independent", "shared"])
def test_multi_agent_ppo_training_step(mapping):
    fn = (lambda aid: aid) if mapping == "independent" \
        else (lambda aid: "shared")

    def cfg(c, env_cls):
        return (c.environment(lambda: env_cls(seed=0))
                .multi_agent(policy_mapping_fn=fn).training(lr=1e-3)
                .env_runners(rollout_fragment_length=40).debugging(seed=6))
    j = cfg(jrl.MultiAgentPPOConfig(), jrl.MultiGuess).build_algo()
    t = cfg(trl.MultiAgentPPOConfig(), trl.MultiGuess).resources(
        device=CPU).build_algo()
    _same_start(j, t)
    per_policy = t.runner.sample(40)       # the port's own rollouts
    j.runner.sample = lambda n: per_policy
    t.runner.sample = lambda n: per_policy
    jm, tm = j.training_step(), t.training_step()
    assert sorted(jm["learner"]) == sorted(tm["learner"])
    trees_close(t.get_weights(), j.get_weights(), whole_tree=True)


# ------------------------------------------------- device-resident CartPole

def test_torch_cartpole_step_matches_numpy_env():
    """One step from the same 256 states, both actions, at the JAX test's
    tolerance (fp32 against the float64 env: rtol 1e-5, atol 1e-6)."""
    vec = TorchCartPoleVector(num_envs=256, seed=3, device=CPU)
    states = vec.reset().numpy().copy()
    actions = np.arange(256) % 2
    nxt, rew, term, trunc = vec.step(torch.from_numpy(actions))
    nxt = nxt.numpy()
    for i in range(256):
        py = trl.CartPole()
        py._state = states[i].astype(np.float64)
        py._t = 0
        want, r, te, tr, _ = py.step(int(actions[i]))
        assert bool(term[i]) == te and bool(trunc[i]) == tr
        assert float(rew[i]) == r
        if not te:   # a terminated lane holds its fresh reset state
            np.testing.assert_allclose(nxt[i], want, rtol=1e-5, atol=1e-6)


def test_torch_cartpole_rollout_and_truncation():
    n, steps = 256, 50
    vec = TorchCartPoleVector(num_envs=n, seed=4, device=CPU)
    vec.reset()
    policy = lambda _p, obs, g: torch.randint(0, 2, (obs.shape[0],),
                                              generator=g)
    obs, actions, rewards, terms, truncs = vec.rollout(
        None, policy, steps, torch.Generator().manual_seed(0))
    assert obs.shape == (steps, n, 4) and actions.shape == (steps, n)
    assert float(rewards.sum()) == steps * n
    assert bool(terms.any()) and not bool(truncs.any())
    # max_steps reached: truncated (not terminated), and t restarts.
    short = TorchCartPoleVector(num_envs=8, max_steps=3, seed=5, device=CPU)
    short.reset()
    for _ in range(3):
        _o, _r, te, tr = short.step(torch.ones(8, dtype=torch.int64))
    assert bool((tr | te).all()) and int(short.t.max()) == 0


def test_jax_weights_drive_the_cartpole_rollout_policy():
    """A JAX PPO module's weights, carried over, act greedily the same on
    the device env's states."""
    spec = jrl.RLModuleSpec(4, 2)
    p = jrl.DiscretePolicyModule(spec).init(jax.random.key(11))
    tp = convert.params_from_numpy(_np_tree(p), device=CPU)
    vec = TorchCartPoleVector(num_envs=512, seed=6, device=CPU)
    states = vec.reset()
    got = trl.DiscretePolicyModule(trl.RLModuleSpec(4, 2)).forward_inference(
        tp, states).numpy()
    want = np.asarray(jrl.DiscretePolicyModule(spec).forward_inference(
        p, states.numpy()))
    np.testing.assert_array_equal(got, want)
