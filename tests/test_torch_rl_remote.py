"""The port's RL process tier against the JAX package: remote env runners,
learner actors with the DDP allreduce, and IMPALA's async pipeline.

- Remote runners (``EnvRunnerGroup(num_env_runners=2)``, StatelessGuess
  behind a ``MeanStdFilter``): runner *i*'s first rollout equals a local
  port ``EnvRunner`` seeded ``seed + 1000 * (i + 1)`` with the same
  weights, bit for bit; against the JAX package's runner of that seed, the
  observations, episode flags and values agree (fp32, 1e-5: the actions
  come from each package's own generator, and this env's observations do
  not depend on them).  Then a weights ref, the connector merge (JAX's
  ``MeanStdFilter.merge_states`` on the same states), the metrics and
  ``stop``.
- DDP (``LearnerGroup(num_learners=2)``): a PPO update on a 64-row batch
  equals JAX's ``LearnerGroup(num_learners=0)`` update on the whole batch
  (fp32, 1e-5 of the tree's scale), through the allreduce and then through
  the caller's gradient mean; the replicas stay bit-identical.
- ``IMPALAConfig()`` at its defaults (2 remote runners, async) and PPO with
  2 runners and 2 learners train 2 iterations with finite losses; ``stop``
  leaves no actor process.

Actors run torch on one thread; every ``get`` has a timeout.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest

import ray_tpu.rl as jrl
import ray_tpu_torch.rl as trl
from ray_tpu_torch import _actor as A
from ray_tpu_torch.rl.ppo import ppo_learner

from _torch_rl import one_thread  # noqa: F401  (autouse)
from _torch_rl import CPU, F32, close, rng, to_port, trees_close

SEED = 3
N_ENVS = 4
ONE_THREAD = {"num_cpus": 1, "env_vars": {"OMP_NUM_THREADS": "1"}}


def _spec(pkg):
    return pkg.RLModuleSpec(4, 4, (32, 32))


@pytest.fixture(scope="module")
def group():
    g = trl.EnvRunnerGroup(
        trl.StatelessGuess, num_env_runners=2, num_envs_per_runner=N_ENVS,
        module_spec=_spec(trl), seed=SEED, runner_resources=ONE_THREAD,
        env_to_module_fn=trl.MeanStdFilter, device=CPU)
    yield g
    g.stop()


def test_remote_runners_against_local_and_jax(group):
    jax_runner = jrl.EnvRunner(jrl.StatelessGuess, num_envs=N_ENVS,
                               module_spec=_spec(jrl), seed=SEED,
                               env_to_module=jrl.MeanStdFilter())
    weights = jax.tree.map(np.asarray, jax_runner.params)
    group.sync_weights(to_port(weights))
    # The sync merged the runners' filter stats (their reset observations):
    # the local runners start from the same connector state.
    synced = A.get([r.get_connector_state.remote() for r in group.remotes],
                   timeout=60)
    rollouts = group.sample(16)
    for i, ro in enumerate(rollouts):
        seed = SEED + 1000 * (i + 1)
        local = trl.EnvRunner(trl.StatelessGuess, num_envs=N_ENVS,
                              module_spec=_spec(trl), seed=seed,
                              env_to_module=trl.MeanStdFilter(), device=CPU)
        local.set_weights(to_port(weights))
        local.set_connector_state(synced[i])
        want = local.sample(16)
        assert sorted(ro) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(ro[k], want[k], err_msg=k)
        j = jrl.EnvRunner(jrl.StatelessGuess, num_envs=N_ENVS,
                          module_spec=_spec(jrl), seed=seed,
                          env_to_module=jrl.MeanStdFilter())
        j.set_weights(weights)
        j.set_connector_state(synced[i])
        jro = j.sample(16)
        for k in ("obs", "dones", "terminateds"):
            np.testing.assert_array_equal(ro[k], jro[k], err_msg=k)
        for k in ("values", "last_values"):
            close(ro[k], jro[k], F32, k)

    # The connector merge: JAX's merge of the runners' states.
    states = A.get([r.get_connector_state.remote() for r in group.remotes],
                   timeout=60)
    want = jrl.ConnectorPipeline([jrl.MeanStdFilter()]).merge_states(states)
    group.sync_weights(A.put(to_port(weights)))
    got = group.connector_state()
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert len(jax.tree.leaves(got)) == 3       # (n, mean, m2)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-12)
    assert A.get([r.ping.remote() for r in group.remotes],
                 timeout=60) == ["ok", "ok"]
    m = group.aggregate_metrics()
    assert m["num_episodes"] == 2 * N_ENVS * 16
    assert m["episode_len_mean"] == 1.0


def _ppo_batch(r, n=64):
    return {"obs": r.normal(size=(n, 4)).astype(np.float32),
            "actions": r.integers(0, 4, n).astype(np.int32),
            "logp_old": np.log(r.uniform(0.2, 0.5, n)).astype(np.float32),
            "advantages": r.normal(size=n).astype(np.float32),
            "value_targets": r.normal(size=n).astype(np.float32),
            "clip_param": np.array([0.2], np.float32),
            "vf_coeff": np.array([0.5], np.float32),
            "ent_coeff": np.array([0.01], np.float32)}


def _jax_learner(lr):
    return jrl.JaxLearner(jrl.DiscretePolicyModule(_spec(jrl)),
                          jrl.ppo.ppo_loss, learning_rate=lr, seed=SEED)


def test_ddp_update_matches_jax_on_the_whole_batch():
    lr = 1e-2
    j = jrl.LearnerGroup(functools.partial(_jax_learner, lr),
                         num_learners=0)
    lg = trl.LearnerGroup(
        functools.partial(ppo_learner, _spec(trl), lr, SEED, CPU),
        num_learners=2, learner_resources=ONE_THREAD)
    try:
        assert lg._ddp
        lg.set_weights(to_port(jax.tree.map(np.asarray, j.get_weights())))
        for step, mode in enumerate(("ddp", "caller_mean")):
            # The second update takes JAX's fallback: the caller averages.
            lg._ddp = mode == "ddp"
            batch = _ppo_batch(rng(20 + step))
            jm = j.update(batch)
            tm = lg.update(batch)
            replicas = A.get([r.get_weights.remote() for r in lg.remotes],
                             timeout=60)
            for a, b in zip(jax.tree.leaves(replicas[0]),
                            jax.tree.leaves(replicas[1])):
                np.testing.assert_array_equal(a, b)
            trees_close(replicas[0], j.get_weights(), whole_tree=True,
                        what=mode)
            # Each shard's mean loss, averaged: the whole batch's.
            close(tm["loss"], jm["loss"], F32, f"{mode} loss")
        assert isinstance(lg.get_weights_ref(), A.ObjectRef)
    finally:
        lg.stop()


def test_impala_default_config_trains_async():
    algo = trl.IMPALAConfig().environment("CartPole-v1").resources(
        device=CPU).build_algo()
    try:
        assert len(algo.env_runner_group.remotes) == 2
        steps = []
        for _ in range(2):
            res = algo.train()
            assert all(np.isfinite(v) for v in res["learner"].values())
            steps.append(res["num_env_steps_sampled"])
        # 4 rollouts of 128 steps x 4 envs an iteration.
        assert steps == [2048, 4096]
        assert len(algo._inflight) == 2
    finally:
        algo.stop()
    assert algo._inflight == {}


def test_ppo_remote_runners_and_ddp_learners_then_stop():
    algo = (trl.PPOConfig().environment("StatelessGuess")
            .resources(device=CPU)
            .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                         rollout_fragment_length=16)
            .learners(num_learners=2).training(minibatch_size=64)
            .build_algo())
    procs = [A._started_proc(h._actor_id) for h in
             algo.env_runner_group.remotes + algo.learner_group.remotes]
    try:
        assert algo.learner_group._ddp
        for _ in range(2):
            res = algo.train()
            assert np.isfinite(res["learner"]["loss"])
        replicas = A.get([r.get_weights.remote()
                          for r in algo.learner_group.remotes], timeout=60)
        for a, b in zip(jax.tree.leaves(replicas[0]),
                        jax.tree.leaves(replicas[1])):
            np.testing.assert_array_equal(a, b)
    finally:
        algo.stop()
    # Killed and reaped: no actor process is left.
    assert all(p.exitcode is not None for p in procs)
