"""The port's tune (``ray_tpu_torch.tune``) against JAX's ``ray_tpu.tune``.

Every case of ``tests/test_tune.py`` runs on both packages: the pure parts
(variants, TPE suggestions, the schedulers' decisions on scripted report
streams) must be equal, value for value, from the same seeds; the Tuner
scenarios run as each package's tasks (JAX's under the conftest
``ray_start`` runtime, the port's under one module-scoped session of 4
CPUs) and must pick the same best trial and pass JAX's own assertions.
Then one trial that trains ``llama_tiny`` fp32 through the port's step,
held to JAX's step from the same weights and batches within
``_torch_parallel.LOSS_RTOL`` (2e-4).

The trainables are module-level functions both packages run (the port's
workers import them by reference); ``_tune()`` is the package whose trial
is running in this process.  The file imports neither torch nor JAX at the
top: every trial worker imports it.
"""

from __future__ import annotations

import math
import os
import shutil
import sys
import tempfile
import time
import uuid

import pytest

import ray_tpu_torch as rtt
import ray_tpu_torch.tune  # noqa: F401 - rtt.tune

TIMEOUT = 120


def _tune():
    """``tune`` of the package whose trial runs in this process."""
    t = sys.modules.get("ray_tpu_torch.tune.tuner")
    if t is not None and t._trial_ctx is not None:
        import ray_tpu_torch.tune as tune
        return tune
    import ray_tpu.tune as tune
    return tune


# -- trainables (both packages run them) ----------------------------------------


def quadratic(config):
    x = config["x"]
    for step in range(1, 6):
        _tune().report({"loss": (x - 3.0) ** 2 + 1.0 / step, "step": step})
    return {"loss": (x - 3.0) ** 2, "x": x}


def slow_trial(config):
    for step in range(1, 10):
        _tune().report({"loss": config["base"] + step * 0.0, "step": step})
        time.sleep(0.05)
    return {"loss": config["base"]}


def sometimes_fails(config):
    if config["x"] == 1:
        raise RuntimeError("bad trial")
    return {"loss": config["x"]}


def objective(config):
    _tune().report({"loss": (config["x"] - 2.0) ** 2})


def hyperband_trainable(config):
    for step in range(1, 28):
        _tune().report({"loss": config["lr"] + 1.0 / step})
        # Paced so trials are still running when the tuner's poll (every
        # 0.2 s at most) files their stops: the port's report is a local
        # store write, and an unpaced trial ends before the first poll.
        time.sleep(0.05)
    return {"loss": config["lr"]}


PBT_TRIALS = 4


def pbt_trainable(config):
    tune = _tune()
    ck = tune.get_checkpoint()
    score = ck["score"] if ck else 0.0
    lr = config["lr"]
    for step in range(1, 33):
        time.sleep(0.12)
        score += 1.0 if abs(lr - 0.1) < 0.05 else 0.1
        tune.report({"score": score}, checkpoint={"score": score, "lr": lr})
        if step == 4:
            _pbt_barrier(config["gate"])
    return {"score": score}


def _pbt_barrier(gate):
    """Every trial has reported its first perturbation interval before any
    goes on, so the scheduler ranks the whole population at the next
    boundary however the host schedules the trials (gated on the others'
    reports, not on time; a restarted trial finds the gate open)."""
    with open(os.path.join(gate, uuid.uuid4().hex), "w"):
        pass
    deadline = time.monotonic() + 120
    while len(os.listdir(gate)) < PBT_TRIALS and \
            time.monotonic() < deadline:
        time.sleep(0.01)


def llama_trial(config):
    """llama_tiny fp32 through the port's step from JAX's weights; reports
    each step's loss."""
    import torch
    torch.set_num_threads(1)
    from _torch_parallel import LR
    from ray_tpu_torch import optim
    from ray_tpu_torch.models import convert
    from ray_tpu_torch.models import llama as t_llama
    from ray_tpu_torch.parallel import build_mesh, make_lm_train_step
    cfg = t_llama.llama_tiny().replace(dtype=torch.float32, remat=False)
    mesh = build_mesh(device="cpu")
    _i, step_fn, place = make_lm_train_step(cfg, mesh,
                                            learning_rate=config["lr"])
    params = convert.params_from_numpy(config["params"], device="cpu")
    state = optim.adamw(LR, b1=0.9, b2=0.95, weight_decay=0.1).init(params)
    for step, b in enumerate(config["data"]):
        params, state, m = step_fn(params, state, place(b))
        _tune().report({"loss": float(m["loss"]), "step": step + 1})


# -- the pure parts: equal from the same seeds ------------------------------------


def _jax():
    import ray_tpu
    import ray_tpu.tune  # noqa: F401 - ray_tpu.tune
    return ray_tpu


def _spaces(pkg):
    t = pkg.tune
    return {
        "grid": {"a": t.grid_search([1, 2]), "b": t.grid_search(["x", "y"]),
                 "c": 7},
        "random": {"x": t.uniform(0, 6), "lr": t.loguniform(1e-5, 1e-1),
                   "n": t.randint(1, 9), "opt": t.choice(["a", "b", "c"])},
        "mixed": {"g": t.grid_search([0.1, 0.2, 0.3]), "u": t.uniform(-1, 1),
                  "k": "const"},
    }


@pytest.mark.parametrize("space", ["grid", "random", "mixed"])
@pytest.mark.parametrize("seed", [0, 3])
def test_variants_equal(space, seed):
    from ray_tpu.tune.search import generate_variants as jax_gen

    from ray_tpu_torch.tune.search import generate_variants as port_gen
    want = jax_gen(_spaces(_jax())[space], num_samples=3, seed=seed)
    got = port_gen(_spaces(rtt)[space], num_samples=3, seed=seed)
    assert got == want
    if space == "grid":   # JAX's test_variant_expansion
        assert len(port_gen(_spaces(rtt)[space], 1)) == 4
        assert all(v["c"] == 7 for v in got)


def _tpe_quadratic(pkg):
    tpe = pkg.tune.TPESearcher({"x": pkg.tune.uniform(-4.0, 4.0)},
                               n_startup_trials=8, seed=0)
    cfgs, best = [], float("inf")
    for i in range(60):
        cfg = tpe.suggest(f"t{i}")
        score = (cfg["x"] - 1.7) ** 2
        best = min(best, score)
        tpe.on_trial_complete(f"t{i}", score)
        cfgs.append(cfg)
    return cfgs, best


def _tpe_categorical_log(pkg):
    tpe = pkg.tune.TPESearcher({"opt": pkg.tune.choice(["good", "bad"]),
                                "lr": pkg.tune.loguniform(1e-5, 1e-1)},
                               n_startup_trials=10, seed=1)
    cfgs = []
    for i in range(50):
        cfg = tpe.suggest(f"t{i}")
        score = (0.0 if cfg["opt"] == "good" else 5.0) + \
            (math.log10(cfg["lr"]) + 3) ** 2
        tpe.on_trial_complete(f"t{i}", score)
        cfgs.append(cfg)
    post = [tpe.suggest(f"p{i}") for i in range(10)]
    return cfgs, post


def test_tpe_suggestions_equal():
    """JAX's TPE cases: the same seed gives the same suggestions, and the
    port's pass JAX's thresholds."""
    want, jbest = _tpe_quadratic(_jax())
    got, best = _tpe_quadratic(rtt)
    assert got == want and best == jbest
    assert best < 0.05
    want = _tpe_categorical_log(_jax())
    got = _tpe_categorical_log(rtt)
    assert got == want
    assert sum(1 for c in got[1] if c["opt"] == "good") >= 8


@pytest.mark.parametrize("pkg_name", ["ray_tpu", "ray_tpu_torch"])
def test_searcher_wrappers(pkg_name):
    """JAX's grid refusal, ConcurrencyLimiter and Repeater cases."""
    import importlib
    tune = importlib.import_module(pkg_name + ".tune")
    with pytest.raises(ValueError, match="grid_search"):
        tune.TPESearcher({"a": tune.grid_search([1, 2])})
    base = tune.BasicVariantSearcher({"x": tune.uniform(0, 1)},
                                     num_samples=10)
    lim = tune.ConcurrencyLimiter(base, max_concurrent=2)
    assert lim.suggest("a") is not None
    assert lim.suggest("b") is not None
    assert lim.suggest("c") is None
    lim.on_trial_complete("a", 0.5)
    assert lim.suggest("c") is not None

    class Recorder(tune.Searcher):
        def __init__(self):
            self.completed = []
            self.n = 0

        def suggest(self, trial_id):
            self.n += 1
            return {"i": self.n}

        def on_trial_complete(self, trial_id, score):
            self.completed.append((trial_id, score))

    rec = Recorder()
    rep = tune.Repeater(rec, repeat=3)
    cfgs = [rep.suggest(f"t{i}") for i in range(3)]
    assert all(c == {"i": 1} for c in cfgs)
    for i, s in enumerate((1.0, 2.0, 3.0)):
        rep.on_trial_complete(f"t{i}", s)
    assert rec.completed == [("group-0", 2.0)]


def _scripted_decisions(pkg):
    """Every scheduler fed the same report streams: the decisions (and
    PBT's restarts)."""
    t = pkg.tune
    out = {}
    asha = t.ASHAScheduler(grace_period=1, reduction_factor=2, max_t=8)
    med = t.MedianStoppingRule(grace_period=1, min_samples_required=2)
    hb = t.HyperBandScheduler(max_t=27, eta=3)
    pbt = t.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=4,
        hyperparam_mutations={"lr": [0.001, 0.01, 0.1, 1.0],
                              "mom": (0.1, 0.9)}, seed=1)
    for i, tid in enumerate("abcdef"):
        pbt.register_trial(tid, {"lr": [0.001, 0.01, 0.1, 1.0][i % 4],
                                 "mom": 0.5})
    rows = []
    for step in range(1, 13):
        for i, tid in enumerate("abcdef"):
            v = ((i * 7919 + step * 104729) % 97) / 97.0 + 0.05 * i
            rows.append((tid, step, v,
                         asha.on_result(tid, step, v),
                         med.on_result(tid, step, v),
                         hb.on_result(tid, step, v),
                         pbt.on_result(tid, step, 10 * step - v * i),
                         pbt.take_restart(tid)))
    out["rows"] = rows
    # JAX's test_schedulers_unit.
    s = t.ASHAScheduler(grace_period=1, reduction_factor=2, max_t=8)
    m = t.MedianStoppingRule(grace_period=1, min_samples_required=2)
    m.on_result("a", 1, 0.1)
    m.on_result("b", 1, 0.2)
    out["unit"] = (s.on_result("a", 1, 0.1), s.on_result("b", 1, 0.9),
                   m.on_result("c", 2, 5.0))
    return out


def test_scheduler_decisions_equal():
    want = _scripted_decisions(_jax())
    got = _scripted_decisions(rtt)
    assert got == want
    assert got["unit"] == ("CONTINUE", "STOP", "STOP")
    assert any(r[3] == "STOP" for r in got["rows"])
    assert any(r[7] is not None for r in got["rows"])


@pytest.mark.parametrize("mode", ["min", "max"])
def test_reports_read_together_are_ranked_best_first(mode):
    """Two trials' reports of rung 2 read in one look reach ASHA best
    first, so the worse trial stops whichever wrote first; the steps
    stay in order."""
    from ray_tpu_torch.tune.schedulers import ASHAScheduler
    from ray_tpu_torch.tune.tuner import in_step_order
    good, bad = (1.0, 2.0) if mode == "min" else (2.0, 1.0)
    for written in ([(2, bad, "b"), (2, good, "a"), (1, bad, "b"),
                     (1, good, "a")],
                    [(1, good, "a"), (2, good, "a"), (1, bad, "b"),
                     (2, bad, "b")]):
        ordered = in_step_order(written, mode)
        assert [r[0] for r in ordered] == [1, 1, 2, 2]
        asha = ASHAScheduler(mode=mode, grace_period=2, reduction_factor=2,
                             max_t=6)
        stops = {r[2] for r in ordered
                 if asha.on_result(r[2], r[0], r[1]) == "STOP"}
        assert stops == {"b"}


# -- the Tuner scenarios, each package's trials as its tasks -----------------------


@pytest.fixture(scope="module")
def port():
    session = rtt.init(num_cpus=4)
    yield session
    rtt.shutdown()


def sc_grid_search(pkg):
    tune = pkg.tune
    grid = tune.Tuner(
        quadratic, param_space={"x": tune.grid_search([0.0, 1.0, 3.0, 5.0])},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    max_concurrent_trials=2)).fit()
    best = grid.get_best_result()
    assert len(grid) == 4
    assert best.config["x"] == 3.0 and best.metrics["loss"] == 0.0
    return sorted(r.config["x"] for r in grid), best.config, \
        sorted(len(r.history) for r in grid)


def sc_random_sampling(pkg):
    tune = pkg.tune
    grid = tune.Tuner(quadratic, param_space={"x": tune.uniform(0, 6)},
                      tune_config=tune.TuneConfig(num_samples=5)).fit()
    xs = sorted(r.config["x"] for r in grid)
    assert len(grid) == 5 and len(set(xs)) == 5
    return xs


def sc_asha_stops_bad_trials(pkg):
    tune = pkg.tune
    sched = tune.ASHAScheduler(metric="loss", mode="min", grace_period=2,
                               reduction_factor=2, max_t=10)
    grid = tune.Tuner(
        slow_trial,
        param_space={"base": tune.grid_search([0.0, 1.0, 2.0, 3.0])},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    scheduler=sched,
                                    max_concurrent_trials=4)).fit()
    assert any(r.stopped_early for r in grid)
    return grid.get_best_result().config


def sc_errored_trial_recorded(pkg):
    tune = pkg.tune
    grid = tune.Tuner(sometimes_fails,
                      param_space={"x": tune.grid_search([0, 1, 2])}).fit()
    errs = [r for r in grid if r.error]
    assert len(errs) == 1 and "bad trial" in errs[0].error
    return len(errs), grid.get_best_result().config


def sc_tuner_with_tpe_search_alg(pkg):
    tune = pkg.tune
    searcher = tune.TPESearcher({"x": tune.uniform(-5.0, 5.0)},
                                n_startup_trials=6, seed=0)
    grid = tune.Tuner(objective, tune_config=tune.TuneConfig(
        metric="loss", mode="min", num_samples=24, max_concurrent_trials=4,
        search_alg=searcher)).fit()
    assert len(grid) == 24
    assert grid.get_best_result().metrics["loss"] < 0.5
    return len(grid)


def sc_hyperband_stops_laggards(pkg):
    tune = pkg.tune
    grid = tune.Tuner(
        hyperband_trainable,
        param_space={"lr": tune.grid_search([0.01, 0.1, 0.5, 1.0, 2.0,
                                             5.0])},
        tune_config=tune.TuneConfig(
            metric="loss", mode="min", max_concurrent_trials=6,
            scheduler=tune.HyperBandScheduler(max_t=27, eta=3))).fit()
    assert any(r.stopped_early for r in grid)
    return grid.get_best_result().config


def sc_pbt_exploit_explore(pkg):
    tune = pkg.tune
    pbt = tune.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=4,
        hyperparam_mutations={"lr": [0.001, 0.01, 0.1, 1.0]}, seed=1)
    gate = tempfile.mkdtemp(prefix="pbt_gate_")
    try:
        grid = tune.Tuner(
            pbt_trainable,
            param_space={"lr": tune.grid_search([0.001, 0.1, 1.0, 0.01]),
                         "gate": gate},
            tune_config=tune.TuneConfig(metric="score", mode="max",
                                        max_concurrent_trials=PBT_TRIALS,
                                        scheduler=pbt)).fit()
    finally:
        shutil.rmtree(gate, ignore_errors=True)
    assert len(grid) == 4
    assert grid.get_best_result().metrics["score"] > 25.0
    assert any(r.restarts > 0 for r in grid)
    return len(grid)


SCENARIOS = [sc_grid_search, sc_random_sampling, sc_asha_stops_bad_trials,
             sc_errored_trial_recorded, sc_tuner_with_tpe_search_alg,
             sc_hyperband_stops_laggards, sc_pbt_exploit_explore]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__[3:] for s in SCENARIOS])
def test_tuner_scenario_matches_jax(scenario, ray_start, port):
    assert scenario(rtt) == scenario(_jax())


def test_trainable_must_pickle_by_reference(port):
    def local(config):
        return {}

    for fn in (lambda c: {}, local):
        with pytest.raises(ValueError, match="top level of a module"):
            rtt.tune.Tuner(fn).fit()
    with pytest.raises(RuntimeError, match="outside a tune trial"):
        rtt.tune.report({"loss": 1.0})


def test_llama_trial_matches_jax_step(ray_start, port):
    """One trial training llama_tiny fp32 (2 adamw steps, lr 1e-2) through
    the port's step reports JAX's losses from the same weights and
    batches, within 2e-4 relative."""
    import numpy as np
    from _torch_parallel import LOSS_RTOL, LR, batches, jax_losses, \
        jax_weights
    params_np = jax_weights({})
    data = batches(8, 64)
    want = jax_losses({"dp": 1}, {}, params_np, data)
    grid = rtt.tune.Tuner(
        llama_trial, param_space={"lr": LR, "params": params_np,
                                  "data": data},
        tune_config=rtt.tune.TuneConfig(metric="loss", mode="min")).fit()
    (trial,) = list(grid)
    assert trial.error is None, trial.error
    got = [h["loss"] for h in trial.history]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert grid.get_best_result().metrics["loss"] == got[-1]
