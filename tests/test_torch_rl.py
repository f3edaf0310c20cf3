"""The port's RL modules, optimizer and learners against the JAX package's,
on the CPU.

Inputs come from numpy seeds; weights are the JAX package's (its modules'
``init``) carried over through numpy (``models.convert``), since threefry's
draws cannot be matched.  Where JAX draws noise (the Gaussian policy's
normals, SAC's and TQC's keys) the test rebuilds JAX's draws from the same
keys and hands them to the port; exploration is compared as log-probs of
the actions drawn, never as samples.

Tolerance: fp32, 1e-5 (``F32``) relative to the largest magnitude of each
compared leaf, unless a test states otherwise.  Params and optimizer
moments after Adam steps are held relative to the largest magnitude in
their whole tree (``trees_close(..., whole_tree=True)``): the bias leaves
start at exactly 0 and move by about the learning rate a step, and where a
gradient element nearly cancels, Adam's m / sqrt(v) turns the last-bit
differences of another summation order into ~1e-5 of such a leaf.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ray_tpu.rl import learner as j_learner
from ray_tpu.rl import models as j_models
from ray_tpu.rl import rl_module as j_mod
from ray_tpu_torch import optim
from ray_tpu_torch.models import convert
from ray_tpu_torch.rl._transfer import to_device
from ray_tpu_torch.rl import learner as t_learner
from ray_tpu_torch.rl import models as t_models
from ray_tpu_torch.rl import rl_module as t_mod

from _torch_rl import one_thread  # noqa: F401  (autouse)
from _torch_rl import CPU, F32, _np, close, rng, t, to_port, trees_close


# ----------------------------------------------------------------- modules

def test_mlp_keys_and_forward():
    dims = (5, 16, 16, 3)
    p = j_mod._init_mlp(jax.random.key(0), dims)
    tp = t_mod._init_mlp(torch.Generator().manual_seed(0), dims)
    assert sorted(p) == sorted(tp)
    for k in p:
        assert tuple(p[k].shape) == tuple(tp[k].shape)
    x = rng().normal(size=(7, 5)).astype(np.float32)
    close(t_mod._mlp(to_port(p), t(x)), jax.jit(j_mod._mlp)(p, x))


def test_discrete_policy_forward_and_exploration_logp():
    spec = j_mod.RLModuleSpec(6, 4, (32, 32))
    jm, tm = j_mod.DiscretePolicyModule(spec), t_mod.DiscretePolicyModule(
        t_mod.RLModuleSpec(6, 4, (32, 32)))
    p = jm.init(jax.random.key(1))
    tp = to_port(p)
    x = rng(1).normal(size=(64, 6)).astype(np.float32)
    jo, to = jax.jit(jm.forward_train)(p, x), tm.forward_train(tp, t(x))
    close(to["action_logits"], jo["action_logits"])
    close(to["value"], jo["value"])
    np.testing.assert_array_equal(
        _np(tm.forward_inference(tp, t(x))),
        np.argmax(np.asarray(jo["action_logits"]), -1))
    # Exploration: the port's draws, scored by JAX's log-softmax.
    a, logp, v = tm.forward_exploration(tp, t(x),
                                        torch.Generator().manual_seed(0))
    want = np.take_along_axis(
        np.asarray(jax.nn.log_softmax(jo["action_logits"])),
        _np(a)[:, None], -1)[:, 0]
    close(logp, want)
    close(v, jo["value"])


def test_categorical_matches_softmax_frequencies():
    """Gumbel-max draws follow softmax(logits) (4e5 draws: 3-sigma of a
    frequency near 0.3 is 2e-3)."""
    logits = torch.tensor([[0.5, -1.0, 1.2, 0.0]]).expand(400_000, 4)
    a = t_mod.categorical(logits, torch.Generator().manual_seed(3))
    freq = np.bincount(_np(a), minlength=4) / len(a)
    np.testing.assert_allclose(freq, _np(torch.softmax(logits[0], -1)),
                               atol=3e-3)


def test_gaussian_sample_with_jax_draws_and_inference():
    spec = j_mod.ContinuousModuleSpec(3, 2, -2.0, 2.0, (32, 32))
    jm = j_mod.GaussianPolicyModule(spec)
    tm = t_mod.GaussianPolicyModule(t_mod.ContinuousModuleSpec(
        3, 2, -2.0, 2.0, (32, 32)))
    p = jm.init(jax.random.key(2))
    tp = to_port(p)
    x = rng(2).normal(size=(50, 3)).astype(np.float32)
    key = jax.random.key(7)
    ja, jlogp = jax.jit(jm.sample)(p, x, key)
    eps = jax.random.normal(key, (50, 2))        # the draws sample() made
    ta, tlogp = tm.sample(tp, t(x), eps=t(eps))
    close(ta, ja)
    close(tlogp, jlogp)
    close(tm.forward_inference(tp, t(x)),
          jax.jit(jm.forward_inference)(p, x))


def test_twin_q_and_q_modules():
    cs = j_mod.ContinuousModuleSpec(3, 2, hidden=(16,))
    jq = j_mod.TwinQModule(cs)
    tq = t_mod.TwinQModule(t_mod.ContinuousModuleSpec(3, 2, hidden=(16,)))
    p = jq.init(jax.random.key(3))
    obs = rng(3).normal(size=(9, 3)).astype(np.float32)
    act = rng(4).uniform(-1, 1, size=(9, 2)).astype(np.float32)
    for got, want in zip(tq.q_values(to_port(p), t(obs), t(act)),
                         jax.jit(jq.q_values)(p, obs, act)):
        close(got, want)
    jm = j_mod.QModule(j_mod.RLModuleSpec(3, 5, (16, 16)))
    tm = t_mod.QModule(t_mod.RLModuleSpec(3, 5, (16, 16)))
    p = jm.init(jax.random.key(4))
    close(tm.q_values(to_port(p), t(obs)), jax.jit(jm.q_values)(p, obs))


@pytest.mark.parametrize("hw,channels,c", [((8, 8), (8, 16), 1),
                                           ((7, 9), (4, 8), 3),
                                           ((84, 84), (16, 32), 4)])
def test_cnn_same_padding_forward_and_grads(hw, channels, c):
    """Even sizes pad (0, 1) at stride 2, odd (1, 1): XLA's SAME."""
    js = j_models.CNNPolicySpec((*hw, c), 3, channels=channels, hidden=32)
    ts = t_models.CNNPolicySpec((*hw, c), 3, channels=channels, hidden=32)
    jm, tm = j_models.CNNPolicyModule(js), t_models.CNNPolicyModule(ts)
    p = jm.init(jax.random.key(5))
    tp = to_port(p)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in tp.items()}
    obs = rng(5).uniform(size=(2, *hw, c)).astype(np.float32)
    jo, to = jax.jit(jm.forward_train)(p, obs), tm.forward_train(tp, t(obs))
    close(to["action_logits"], jo["action_logits"])
    close(to["value"], jo["value"])
    jg = jax.jit(jax.grad(lambda q: jnp.sum(jm.forward_train(q, obs)
                                    ["action_logits"] ** 2)))(p)
    _, tg = t_learner.value_and_grad(
        lambda q: torch.sum(tm.forward_train(q, t(obs))
                            ["action_logits"] ** 2), tp)
    trees_close(tg, jg, what="cnn grads")


def test_same_padding_rule():
    assert t_models.same_padding(84, 3, 2) == (0, 1)
    assert t_models.same_padding(7, 3, 2) == (1, 1)
    assert t_models.same_padding(8, 3, 1) == (1, 1)
    assert t_models.same_padding(5, 1, 2) == (0, 0)


def test_gru_forward_train_with_resets_and_grads():
    js = j_models.RecurrentPolicySpec(3, 4, hidden=8, embed=(16,))
    ts = t_models.RecurrentPolicySpec(3, 4, hidden=8, embed=(16,))
    jm, tm = j_models.GRUPolicyModule(js), t_models.GRUPolicyModule(ts)
    p = jm.init(jax.random.key(6))
    p["w_v"] = jax.random.normal(jax.random.key(9), (8, 1))  # not all zero
    tp = to_port(p)
    r = rng(6)
    obs = r.normal(size=(3, 12, 3)).astype(np.float32)
    h0 = r.normal(size=(3, 8)).astype(np.float32)
    resets = r.random((3, 12)) < 0.2
    jo = jax.jit(jm.forward_train)(p, obs, h0, resets)
    to = tm.forward_train(tp, t(obs), t(h0), t(resets))
    close(to["action_logits"], jo["action_logits"])
    close(to["value"], jo["value"])

    def jl(q):
        o = jm.forward_train(q, obs, h0, resets)
        return jnp.sum(o["action_logits"] ** 2) + jnp.sum(o["value"])

    def tl(q):
        o = tm.forward_train(q, t(obs), t(h0), t(resets))
        return torch.sum(o["action_logits"] ** 2) + torch.sum(o["value"])

    _, tg = t_learner.value_and_grad(tl, tp)
    trees_close(tg, jax.jit(jax.grad(jl))(p), what="gru grads")
    # One step of forward_step is the scan's first step.
    lg, v, h = tm.forward_step(tp, t(obs[:, 0]), t(h0))
    jlg, jv, jh = jax.jit(jm.forward_step)(p, obs[:, 0], h0)
    close(lg, jlg)
    close(h, jh)


# --------------------------------------------------------------- optimizer

@pytest.mark.parametrize("max_norm", [0.05, 100.0])
def test_chain_clip_adam_matches_optax(max_norm):
    """Three steps, the clip active (0.05) and not (100); the states too."""
    import optax
    r = rng(8)
    params = {"a": r.normal(size=(4, 3)).astype(np.float32),
              "b": {"c": r.normal(size=(5,)).astype(np.float32)}}
    grads = [jax.tree.map(lambda x: r.normal(size=x.shape).astype(
        np.float32), params) for _ in range(3)]
    jopt = optax.chain(optax.clip_by_global_norm(max_norm),
                       optax.adam(1e-2))
    topt = optim.chain(optim.clip_by_global_norm(max_norm),
                       optim.adam(1e-2))
    jp, js = params, jopt.init(params)
    tp = to_port(params)
    ts = topt.init(tp)
    for g in grads:
        u, js = jopt.update(g, js, jp)
        jp = optax.apply_updates(jp, u)
        tu, ts = topt.update(to_port(g), ts, tp)
        tp = optim.apply_updates(tp, tu)
    trees_close(tp, jp, what="params", whole_tree=True)
    trees_close(ts, js, what="state", whole_tree=True)
    conv = convert.optax_state_from_numpy(jax.tree.map(np.asarray, js),
                                          device=CPU)
    trees_close(conv, js, tol=0, what="converted state")
    assert type(conv[1][0]) is optim.AdamState
    assert conv[0] == optim.EmptyState()


def test_clip_is_optax_rule_not_torch_clip_grad_norm():
    """At norm exactly max_norm optax leaves the update as it is
    (norm >= max_norm scales by max_norm / norm = 1); torch's
    clip_grad_norm_ scales by max_norm / (norm + 1e-6)."""
    g = {"w": torch.tensor([3.0, 4.0])}                     # norm 5
    out, _ = optim.clip_by_global_norm(5.0).update(g, optim.EmptyState())
    assert torch.equal(out["w"], g["w"])
    out, _ = optim.clip_by_global_norm(2.5).update(g, optim.EmptyState())
    np.testing.assert_allclose(_np(out["w"]), [1.5, 2.0], rtol=1e-7)


# ---------------------------------------------------------------- learners

def _learner_pair(j_module, t_module, j_loss, t_loss, seed=0):
    jl = j_learner.JaxLearner(j_module, j_loss, learning_rate=1e-3,
                              seed=seed)
    tl = t_learner.TorchLearner(t_module, t_loss, learning_rate=1e-3,
                                device=CPU)
    tl.set_weights(jax.tree.map(np.asarray, jl.params))
    tl.opt_state = convert.optax_state_from_numpy(
        jax.tree.map(np.asarray, jl.opt_state), device=CPU)
    return jl, tl


def _check_update(jl, tl, batch, steps=2):
    for _ in range(steps):
        jm = jl.update(batch)
        tm = tl.update(batch)
    assert sorted(jm) == list(tm)
    for k in jm:
        close(tm[k], jm[k], what=k)
    trees_close(tl.params, jl.params, what="params", whole_tree=True)
    trees_close(tl.opt_state, jl.opt_state, what="opt_state",
                whole_tree=True)


def _disc_pair(obs_dim=4, n_act=3, hidden=(32, 32)):
    return (j_mod.DiscretePolicyModule(j_mod.RLModuleSpec(obs_dim, n_act,
                                                          hidden)),
            t_mod.DiscretePolicyModule(t_mod.RLModuleSpec(obs_dim, n_act,
                                                          hidden)))


def _disc_batch(r, n=64, obs_dim=4, n_act=3):
    return {"obs": r.normal(size=(n, obs_dim)).astype(np.float32),
            "actions": r.integers(0, n_act, n).astype(np.int32)}


def _ppo_batch(r):
    b = _disc_batch(r)
    b.update(logp_old=np.log(r.uniform(0.2, 0.5, 64)).astype(np.float32),
             advantages=r.normal(size=64).astype(np.float32),
             value_targets=r.normal(size=64).astype(np.float32),
             clip_param=np.array([0.2], np.float32),
             vf_coeff=np.array([0.5], np.float32),
             ent_coeff=np.array([0.01], np.float32))
    return b


def _impala_batch(r):
    b = _disc_batch(r)
    b.update(pg_advantages=r.normal(size=64).astype(np.float32),
             vs_targets=r.normal(size=64).astype(np.float32),
             behavior_logp=np.log(r.uniform(0.2, 0.5, 64)).astype(
                 np.float32),
             vf_coeff=np.array([0.5], np.float32),
             ent_coeff=np.array([0.01], np.float32),
             clip_param=np.array([0.3], np.float32))
    return b


def _losses(name):
    from ray_tpu.rl import impala as ji, offline as jo, ppo as jp
    from ray_tpu_torch.rl import impala as ti, offline as to, ppo as tp
    return {"ppo": (jp.ppo_loss, tp.ppo_loss, _ppo_batch),
            "impala": (ji.impala_loss, ti.impala_loss, _impala_batch),
            "appo": (ji.appo_loss, ti.appo_loss, _impala_batch),
            "bc": (jo.bc_discrete_loss, to.bc_discrete_loss, _disc_batch),
            "marwil": (jo.marwil_loss, to.marwil_loss,
                       lambda r: dict(_disc_batch(r),
                                      returns_to_go=r.normal(size=64).astype(
                                          np.float32),
                                      beta=np.array([1.0], np.float32)))
            }[name]


@pytest.mark.parametrize("name", ["ppo", "impala", "appo", "bc", "marwil"])
def test_discrete_policy_loss_and_learner_update(name):
    j_loss, t_loss, make = _losses(name)
    jmod, tmod = _disc_pair()
    jl, tl = _learner_pair(jmod, tmod, j_loss, t_loss)
    batch = make(rng(10))
    (jv, jaux), jg = jax.jit(jax.value_and_grad(
        lambda q: j_loss(jmod, q, batch), has_aux=True))(jl.params)
    (tv, taux), tg = t_learner.value_and_grad(
        lambda q: t_loss(tmod, q, to_device(batch, tl.device)),
        tl.params)
    close(tv, jv, what="loss")
    for k in jaux:
        close(taux[k], jaux[k], what=k)
    trees_close(tg, jg, what="grads")
    _check_update(jl, tl, batch)


def test_bc_continuous_update():
    from ray_tpu.rl import offline as jo
    from ray_tpu_torch.rl import offline as to
    js = j_mod.ContinuousModuleSpec(2, 2, -2.0, 2.0, (32,))
    ts = t_mod.ContinuousModuleSpec(2, 2, -2.0, 2.0, (32,))
    jl, tl = _learner_pair(j_mod.GaussianPolicyModule(js),
                           t_mod.GaussianPolicyModule(ts),
                           jo.bc_continuous_loss, to.bc_continuous_loss)
    r = rng(11)
    _check_update(jl, tl, {
        "obs": r.normal(size=(32, 2)).astype(np.float32),
        "actions": r.uniform(-2, 2, (32, 2)).astype(np.float32)})


@pytest.mark.parametrize("weights", [False, True])
def test_dqn_and_cql_losses_update(weights):
    from ray_tpu.rl import dqn as jd, offline as jo
    from ray_tpu_torch.rl import dqn as td, offline as to
    r = rng(12)
    batch = dict(_disc_batch(r), targets=r.normal(size=64).astype(
        np.float32))
    if weights:
        batch["weights"] = r.uniform(0.1, 1.0, 64).astype(np.float32)
    spec = (4, 3, (32, 32))
    jl, tl = _learner_pair(j_mod.QModule(j_mod.RLModuleSpec(*spec)),
                           t_mod.QModule(t_mod.RLModuleSpec(*spec)),
                           jd.dqn_loss, td.dqn_loss)
    _check_update(jl, tl, batch)
    batch.pop("weights", None)
    batch["cql_alpha"] = np.array([0.5], np.float32)
    jl, tl = _learner_pair(j_mod.QModule(j_mod.RLModuleSpec(*spec)),
                           t_mod.QModule(t_mod.RLModuleSpec(*spec)),
                           jo.cql_loss, to.cql_loss)
    _check_update(jl, tl, batch)


def test_recurrent_ppo_loss_update():
    from ray_tpu.rl import ppo as jp
    from ray_tpu_torch.rl import ppo as tp
    js = j_models.RecurrentPolicySpec(3, 2, hidden=8, embed=(16,))
    ts = t_models.RecurrentPolicySpec(3, 2, hidden=8, embed=(16,))
    jl, tl = _learner_pair(j_models.GRUPolicyModule(js),
                           t_models.GRUPolicyModule(ts),
                           jp.ppo_loss_recurrent, tp.ppo_loss_recurrent)
    r = rng(13)
    B, T = 4, 10
    batch = {"obs": r.normal(size=(B, T, 3)).astype(np.float32),
             "actions": r.integers(0, 2, (B, T)).astype(np.int32),
             "logp_old": np.log(r.uniform(0.3, 0.7, (B, T))).astype(
                 np.float32),
             "advantages": r.normal(size=(B, T)).astype(np.float32),
             "value_targets": r.normal(size=(B, T)).astype(np.float32),
             "state_in": r.normal(size=(B, 8)).astype(np.float32),
             "resets": r.random((B, T)) < 0.2,
             "clip_param": np.array([0.2], np.float32),
             "vf_coeff": np.array([0.5], np.float32),
             "ent_coeff": np.array([0.01], np.float32)}
    _check_update(jl, tl, batch)


def test_iql_update():
    from ray_tpu.rl import iql as ji
    from ray_tpu_torch.rl import iql as ti
    spec = (4, 3, (32, 32))
    jl, tl = _learner_pair(ji.IQLModule(j_mod.RLModuleSpec(*spec)),
                           ti.IQLModule(t_mod.RLModuleSpec(*spec)),
                           ji.iql_loss, ti.iql_loss)
    r = rng(14)
    target_q = jax.tree.map(lambda x: np.asarray(x) + 0.1,
                            jl.params["q"])
    batch = dict(_disc_batch(r),
                 rewards=r.normal(size=64).astype(np.float32),
                 next_obs=r.normal(size=(64, 4)).astype(np.float32),
                 terminateds=(r.random(64) < 0.2).astype(np.float32),
                 target_q=target_q,
                 gamma=np.array([0.99], np.float32),
                 expectile=np.array([0.8], np.float32),
                 awr_beta=np.array([3.0], np.float32))
    _check_update(jl, tl, batch)


def test_learner_makes_one_metrics_transfer(monkeypatch):
    """One device -> host read per update: ``fetch`` is the only reader
    and it runs once (on the card it is the update's one host sync)."""
    from ray_tpu_torch.rl import _transfer, ppo as tp
    _, tmod = _disc_pair()
    tl = t_learner.TorchLearner(tmod, tp.ppo_loss, device=CPU)
    calls = []
    real = _transfer.fetch
    monkeypatch.setattr(_transfer, "fetch",
                        lambda *v: calls.append(len(v)) or real(*v))
    out = tl.update(_ppo_batch(rng(15)))
    assert calls == [len(out)]
    assert set(out) == {"entropy", "grad_norm", "kl", "loss",
                        "policy_loss", "vf_loss"}


def test_learner_group_and_runner_group_refuse_remote():
    """Remote learners and runners are process actors, which import their
    factories by reference: a lambda is refused at once, naming the rule
    (the JAX package ships it with cloudpickle)."""
    from ray_tpu_torch.rl import EnvRunnerGroup, LearnerGroup
    with pytest.raises(ValueError, match="top level of a module"):
        LearnerGroup(lambda: None, num_learners=2)
    with pytest.raises(ValueError, match="top level of a module"):
        EnvRunnerGroup(lambda: None, num_env_runners=2, device=CPU)


def test_value_and_grad_zero_for_unused_leaf():
    p = {"a": torch.ones(2), "b": torch.ones(3)}
    out, g = t_learner.value_and_grad(lambda q: (q["a"] * 2).sum(), p)
    assert torch.equal(g["a"], torch.full((2,), 2.0))
    assert torch.equal(g["b"], torch.zeros(3))
