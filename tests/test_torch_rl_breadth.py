"""The port's twins of the JAX package's RL tests (``tests/test_rl.py``,
``tests/test_rl_breadth.py``) that need neither the actor runtime nor
``ray_tpu.data``: envs, buffers, GAE, V-trace and connectors (the numpy
copies), the env runner, and the on-policy algorithms and model zoo
learning to the JAX tests' own thresholds (recurrent PPO too), all on the
CPU.  The off-policy and offline twins are in
``test_torch_rl_offpolicy.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ray_tpu_torch.rl import (CartPole, CNNPolicyModule, CNNPolicySpec,
                              ConnectorPipeline, DiscretePolicyModule,
                              EnvRunner, FrameStack, GRUPolicyModule,
                              IMPALAConfig, APPOConfig, MeanStdFilter,
                              MultiAgentPPOConfig, MultiGuess, PPOConfig,
                              PrioritizedReplayBuffer, RecurrentPolicySpec,
                              ReplayBuffer, RewardClip, RLModuleSpec,
                              StatelessGuess, VectorEnv, compute_gae, vtrace)
from ray_tpu_torch.rl.env import DelayedRecall
from ray_tpu_torch.rl.learner import value_and_grad

from _torch_rl import one_thread  # noqa: F401  (autouse)

DEV = "cpu"


class TestEnvs:
    def test_cartpole_dynamics(self):
        env = CartPole()
        obs, _ = env.reset(seed=0)
        assert obs.shape == (4,)
        total = 0.0
        for _ in range(50):
            obs, r, term, trunc, _ = env.step(1)
            total += r
            if term or trunc:
                break
        assert total >= 1.0

    def test_vector_env_autoreset(self):
        vec = VectorEnv(CartPole, 3, seed=0)
        obs = vec.reset()
        assert obs.shape == (3, 4)
        saw_done = False
        for _ in range(200):
            obs, rewards, dones, terms, final_obs = vec.step(
                np.ones(3, np.int32))
            assert obs.shape == (3, 4)
            if dones.any():
                saw_done = True
                i = int(np.nonzero(dones)[0][0])
                assert not np.allclose(final_obs[i], obs[i])
                break
        assert saw_done


class TestEnvRunner:
    def test_sample_shapes(self):
        runner = EnvRunner(CartPole, num_envs=2, seed=0, device=DEV)
        batch = runner.sample(16)
        assert batch["obs"].shape == (16, 2, 4)
        assert batch["actions"].shape == (16, 2)
        assert batch["last_values"].shape == (2,)
        assert "episode_return_mean" in runner.metrics()

    def test_custom_module_and_reward_connector(self):
        spec = RLModuleSpec(4, 2, hidden=(8,))
        runner = EnvRunner(lambda: CartPole(max_steps=20), num_envs=2,
                           module_spec=spec,
                           module=DiscretePolicyModule(spec),
                           reward_connector=RewardClip(0.5), device=DEV)
        batch = runner.sample(num_steps=10)
        assert batch["rewards"].shape == (10, 2)
        assert np.all(batch["rewards"] == 0.5)

    def test_truncation_bootstraps_from_final_obs(self):
        """CartPole capped at 5 steps truncates: the runner records
        V(final_obs) at exactly the truncated steps."""
        runner = EnvRunner(lambda: CartPole(max_steps=5), num_envs=2,
                           seed=1, device=DEV)
        b = runner.sample(12)
        trunc = b["dones"] & ~b["terminateds"]
        assert trunc.any()
        assert np.all(b["bootstrap_values"][~trunc] == 0)
        assert np.all(b["bootstrap_values"][trunc] != 0)


class TestBuffers:
    def test_replay_ring(self):
        buf = ReplayBuffer(8, seed=0)
        buf.add(x=np.arange(6, dtype=np.float32))
        assert len(buf) == 6
        buf.add(x=np.arange(6, 12, dtype=np.float32))
        assert len(buf) == 8
        assert buf.sample(4)["x"].shape == (4,)

    def test_prioritized(self):
        buf = PrioritizedReplayBuffer(16, seed=0)
        buf.add(x=np.arange(10, dtype=np.float32))
        batch, idx, w = buf.sample(5)
        assert w.shape == (5,) and w.max() <= 1.0
        buf.update_priorities(idx, np.full(5, 10.0))
        _b2, idx2, _ = buf.sample(200)
        assert np.isin(idx2, idx).mean() > 0.5


class TestGAE:
    def test_terminal_vs_truncation(self):
        rewards = np.ones((3, 1), np.float32)
        values = np.zeros((3, 1), np.float32)
        dones = np.array([[False], [False], [True]])
        last = np.zeros(1, np.float32)
        terms = dones.copy()
        _adv_t, ret_t = compute_gae(rewards, values, dones, terms, last,
                                    0.99, 1.0)
        boot = np.zeros((3, 1), np.float32)
        boot[2, 0] = 100.0
        _adv_u, ret_u = compute_gae(rewards, values, dones,
                                    np.zeros_like(terms), last, 0.99, 1.0,
                                    boot)
        assert ret_u[2, 0] == pytest.approx(1 + 0.99 * 100.0, rel=1e-5)
        assert ret_t[2, 0] == pytest.approx(1.0, rel=1e-5)
        assert ret_t[0, 0] == pytest.approx(1 + 0.99 + 0.99 ** 2, rel=1e-4)

    def test_no_bootstrap_from_reset_state(self):
        rewards = np.ones((2, 1), np.float32)
        values = np.array([[0.0], [55.0]], np.float32)
        dones = np.array([[True], [False]])
        terms = np.zeros_like(dones)
        boot = np.zeros((2, 1), np.float32)
        _adv, ret = compute_gae(rewards, values, dones, terms,
                                np.zeros(1, np.float32), 0.99, 1.0, boot)
        assert ret[0, 0] == pytest.approx(1.0, rel=1e-5)


class TestPPO:
    def test_learns_stateless_guess(self):
        algo = (PPOConfig()
                .environment(lambda: StatelessGuess(4))
                .env_runners(num_envs_per_env_runner=8,
                             rollout_fragment_length=64)
                .training(lr=5e-3, num_epochs=4, minibatch_size=128,
                          entropy_coeff=0.0)
                .debugging(seed=0).resources(device=DEV)
                .build_algo())
        algo.train()
        for _ in range(14):
            last = algo.train()
        ret = last["env_runners"]["episode_return_mean"]
        assert ret > 0.6, f"PPO failed to learn: return={ret}"
        assert last["learner"]["loss"] == last["learner"]["loss"]

    def test_checkpoint_roundtrip(self, tmp_path):
        algo = (PPOConfig().environment("CartPole-v1")
                .env_runners(rollout_fragment_length=8)
                .resources(device=DEV).build_algo())
        algo.train()
        ckpt = algo.save(str(tmp_path / "ckpt"))
        w0 = algo.get_weights()
        algo2 = (PPOConfig().environment("CartPole-v1")
                 .env_runners(rollout_fragment_length=8)
                 .resources(device=DEV).build_algo())
        algo2.restore(ckpt)
        for k in w0:
            for n in w0[k]:
                assert torch.equal(w0[k][n], algo2.get_weights()[k][n])
        assert algo2.iteration == algo.iteration

    def test_with_connectors_learns(self):
        cfg = (PPOConfig().environment("StatelessGuess")
               .env_runners(rollout_fragment_length=64,
                            env_to_module_connector=lambda: [
                                MeanStdFilter()])
               .training(lr=5e-3).debugging(seed=0).resources(device=DEV))
        algo = cfg.build_algo()
        for _ in range(12):
            r = algo.train()
        assert r["env_runners"]["episode_return_mean"] > 0.9


class TestConnectors:
    def test_meanstd_filter_stats(self):
        f = MeanStdFilter()
        data = np.random.default_rng(0).normal(5.0, 2.0, size=(200, 3)
                                                ).astype(np.float32)
        for i in range(0, 200, 20):
            f(data[i:i + 20])
        normed = f.transform(data)
        assert abs(float(normed.mean())) < 0.1
        assert abs(float(normed.std()) - 1.0) < 0.1
        n_before = f.count
        f.transform(data)
        assert f.count == n_before == 200

    def test_framestack_shapes_and_transform(self):
        fs = FrameStack(3)
        assert fs(np.ones((2, 4), np.float32)).shape == (2, 12)
        out2 = fs(2 * np.ones((2, 4), np.float32))
        assert out2[0, -1] == 2.0 and out2[0, 0] == 1.0
        peek = fs.transform(3 * np.ones((2, 4), np.float32))
        assert peek[0, -1] == 3.0
        np.testing.assert_array_equal(
            peek, fs.transform(3 * np.ones((2, 4), np.float32)))

    def test_framestack_clears_history_at_episode_boundary(self):
        fs = FrameStack(3)
        fs(np.ones((2, 2), np.float32))
        fs(2 * np.ones((2, 2), np.float32))
        fs.on_episode_boundaries(np.array([True, False]))
        out = fs(np.stack([7 * np.ones(2), 3 * np.ones(2)]).astype(
            np.float32))
        np.testing.assert_array_equal(out[0], np.full(6, 7.0, np.float32))
        np.testing.assert_array_equal(
            out[1], np.array([1, 1, 2, 2, 3, 3], np.float32))

    def test_meanstd_merge_states(self):
        all_data = np.random.default_rng(0).normal(
            3.0, 1.5, size=(400, 2)).astype(np.float32)
        a, b = MeanStdFilter(), MeanStdFilter()
        a(all_data[:150])
        b(all_data[150:])
        merged = a.merge_states([a.get_state(), b.get_state()])
        whole = MeanStdFilter()
        whole(all_data)
        n, mean, m2 = merged["base"]
        wn, wmean, wm2 = whole._combined()
        assert n == wn == 400
        np.testing.assert_allclose(mean, wmean, rtol=1e-6)
        np.testing.assert_allclose(m2, wm2, rtol=1e-6)

    def test_meanstd_sync_does_not_double_count(self):
        rng = np.random.default_rng(1)
        r1, r2, proto = MeanStdFilter(), MeanStdFilter(), MeanStdFilter()
        total = 0
        for _ in range(5):
            r1(rng.normal(size=(30, 2)).astype(np.float32))
            r2(rng.normal(size=(50, 2)).astype(np.float32))
            total += 80
            merged = proto.merge_states([r1.get_state(), r2.get_state()])
            r1.set_state(merged)
            r2.set_state(merged)
            assert r1.count == r2.count == total

    def test_state_sync_roundtrip(self):
        p1 = ConnectorPipeline([MeanStdFilter()])
        p1(np.arange(12, dtype=np.float32).reshape(4, 3))
        p2 = ConnectorPipeline([MeanStdFilter()])
        p2.set_state(p1.get_state())
        x = np.ones((1, 3), np.float32)
        np.testing.assert_allclose(p1.transform(x), p2.transform(x))


class TestIMPALA:
    def test_vtrace_on_policy_matches_returns(self):
        T, N = 5, 2
        rewards = np.random.default_rng(0).normal(size=(T, N)).astype(
            np.float32)
        z = np.zeros((T, N), np.float32)
        logp = np.full((T, N), -0.5, np.float32)
        no = np.zeros((T, N), bool)
        vs, _pg = vtrace(logp, logp, rewards, z, no, no, z,
                         np.zeros(N, np.float32), gamma=0.9)
        expect = np.zeros((T, N), np.float32)
        acc = np.zeros(N, np.float32)
        for t in reversed(range(T)):
            acc = rewards[t] + 0.9 * acc
            expect[t] = acc
        np.testing.assert_allclose(vs, expect, rtol=1e-5)

    def test_vtrace_terminated_stops_bootstrap(self):
        T, N = 3, 1
        values = np.full((T, N), 10.0, np.float32)
        logp = np.zeros((T, N), np.float32)
        dones = np.zeros((T, N), bool)
        dones[1, 0] = True
        vs, _ = vtrace(logp, logp, np.ones((T, N), np.float32), values,
                       dones, dones.copy(), np.zeros((T, N), np.float32),
                       np.full(N, 10.0, np.float32), gamma=1.0,
                       rho_clip=10.0, c_clip=10.0)
        assert vs[1, 0] == pytest.approx(1.0)

    @pytest.mark.parametrize("cfg_cls", [IMPALAConfig, APPOConfig])
    def test_sync_learns(self, cfg_cls):
        cfg = (cfg_cls().environment("StatelessGuess")
               .env_runners(num_env_runners=0, rollout_fragment_length=64)
               .training(lr=5e-3, batches_per_iteration=4)
               .debugging(seed=0).resources(device=DEV))
        if cfg_cls is APPOConfig:
            cfg = cfg.training(clip_param=0.2)
        algo = cfg.build_algo()
        for _ in range(10):
            r = algo.train()
        assert r["env_runners"]["episode_return_mean"] > 0.9


class TestMultiAgent:
    @pytest.mark.parametrize("mapping,pids", [
        (lambda aid: aid, {"a0", "a1"}),
        (lambda aid: "shared", {"shared"})])
    def test_policies_learn(self, mapping, pids):
        cfg = (MultiAgentPPOConfig()
               .environment(lambda: MultiGuess(seed=0))
               .multi_agent(policy_mapping_fn=mapping)
               .training(lr=5e-3)
               .env_runners(rollout_fragment_length=256)
               .debugging(seed=0).resources(device=DEV))
        algo = cfg.build_algo()
        for _ in range(10):
            r = algo.train()
        assert r["env_runners"]["episode_return_mean"] > 1.7
        assert set(algo.learners) == pids


class TestModelZoo:
    def test_cnn_policy_shapes_and_learns_pattern(self):
        spec = CNNPolicySpec(obs_shape=(8, 8, 1), num_actions=2,
                             channels=(8, 16), hidden=32)
        mod = CNNPolicyModule(spec)
        params = mod.init(torch.Generator().manual_seed(0))
        rng = np.random.default_rng(0)
        imgs = np.zeros((64, 8, 8, 1), np.float32)
        labels = rng.integers(0, 2, 64)
        for i, y in enumerate(labels):
            if y == 0:
                imgs[i, :4, :4, 0] = 1.0
            else:
                imgs[i, 4:, 4:, 0] = 1.0
        obs, lab = torch.from_numpy(imgs), torch.from_numpy(labels)
        out = mod.forward_train(params, obs)
        assert out["action_logits"].shape == (64, 2)
        assert out["value"].shape == (64,)

        def loss(p):
            lg = mod.forward_train(p, obs)["action_logits"]
            return -torch.mean(torch.log_softmax(lg, -1)[torch.arange(64),
                                                         lab])

        l0 = float(loss(params))
        for _ in range(60):
            _, g = value_and_grad(loss, params)
            params = {k: params[k] - 0.5 * g[k] for k in params}
        assert float(loss(params)) < l0 * 0.2
        acc = float((mod.forward_inference(params, obs) == lab).float()
                    .mean())
        assert acc > 0.95

    def test_gru_train_matches_stepwise(self):
        mod = GRUPolicyModule(RecurrentPolicySpec(obs_dim=3, num_actions=4,
                                                  hidden=8))
        params = mod.init(torch.Generator().manual_seed(1))
        obs_seq = torch.from_numpy(np.random.default_rng(1).normal(
            size=(2, 5, 3)).astype(np.float32))
        h0 = mod.initial_state(2)
        out = mod.forward_train(params, obs_seq, h0)
        assert out["action_logits"].shape == (2, 5, 4)
        assert out["value"].shape == (2, 5)
        h = h0
        for t in range(5):
            lg, _v, h = mod.forward_step(params, obs_seq[:, t], h)
            np.testing.assert_allclose(lg.numpy(),
                                       out["action_logits"][:, t].numpy(),
                                       rtol=1e-5, atol=1e-5)

    def test_gru_uses_memory(self):
        mod = GRUPolicyModule(RecurrentPolicySpec(obs_dim=2, num_actions=2,
                                                  hidden=16))
        params = mod.init(torch.Generator().manual_seed(2))
        rng = np.random.default_rng(2)
        first = rng.integers(0, 2, 64)
        seqs = np.zeros((64, 6, 2), np.float32)
        seqs[np.arange(64), 0, first] = 1.0
        obs, lab = torch.from_numpy(seqs), torch.from_numpy(first)

        def loss(p):
            lg = mod.forward_train(p, obs,
                                   mod.initial_state(64))["action_logits"]
            return -torch.mean(torch.log_softmax(lg[:, -1], -1)[
                torch.arange(64), lab])

        for _ in range(150):
            _, g = value_and_grad(loss, params)
            params = {k: params[k] - 0.5 * g[k] for k in params}
        assert float(loss(params)) < 0.1


def _train_recall(module_factory, iters, seed=0):
    cfg = (PPOConfig()
           .environment(lambda: DelayedRecall(delay=3))
           .env_runners(num_envs_per_env_runner=16,
                        rollout_fragment_length=32)
           .training(lr=5e-3, num_epochs=6, minibatch_size=256,
                     gamma=0.9, entropy_coeff=0.003)
           .debugging(seed=seed).resources(device=DEV))
    if module_factory is not None:
        cfg = cfg.rl_module(module_factory=module_factory)
    algo = cfg.build_algo()
    for _ in range(iters):
        last = algo.train()
    return last["env_runners"]["episode_return_mean"]


def test_gru_ppo_beats_memoryless_on_memory_task():
    """GRU-PPO through the whole Algorithm / EnvRunner / Learner stack
    (``tests/test_rl_breadth.py::TestRecurrentPPO``).  DelayedRecall pays
    only for remembering the first observation: the memoryless MLP is
    capped at ~1/2 expected return; the GRU module through the same stack
    must clearly beat it."""
    def gru_factory():
        return GRUPolicyModule(RecurrentPolicySpec(
            obs_dim=3, num_actions=2, hidden=16, embed=(32,)))

    ret_gru = _train_recall(gru_factory, iters=25)
    ret_mlp = _train_recall(None, iters=25)
    assert ret_mlp < 0.75, f"memoryless should be capped: {ret_mlp}"
    assert ret_gru > 0.85, f"GRU-PPO failed to learn: {ret_gru}"
    assert ret_gru > ret_mlp + 0.15
