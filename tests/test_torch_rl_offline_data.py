"""Offline RL from parquet shards and ``Dataset`` inputs, the port against
the JAX package (the inputs ``ray_tpu_torch/rl/offline.py`` refused before
the port had a data library).

The same episodes (600 steps of StatelessGuess from a seeded behaviour
policy) go to both packages as parquet shards written by each package's
``save_parquet`` and as each package's ``Dataset.from_numpy``; BC, MARWIL
and CQL then take a whole ``training_step`` (3 updates on the same numpy
minibatches) from the same weights, and the port's metrics and weights
must equal JAX's within fp32 1e-5 of the tree (``tests/_torch_rl.py``).
The updates run on the driver-local data path, where both packages read
the shards in file order; under a task session (``init``) the writes are
tasks and blocks may arrive in any order, so there the columns read back
are compared as multisets.
"""

from __future__ import annotations

import numpy as np
import pytest

import ray_tpu.rl as jrl
import ray_tpu_torch as rtt
import ray_tpu_torch.rl as trl

from _torch_rl import one_thread  # noqa: F401  (autouse)
from _torch_rl import CPU, close, trees_close


def _same_start(j_algo, t_algo):
    """The port's algorithm onto the JAX one's weights (fresh optimizer
    states are zeros in both)."""
    import jax
    t_algo.set_weights(jax.tree.map(np.asarray, j_algo.get_weights()))


def _sorted_rows(cols):
    """Every column side by side, rows in lexicographic order."""
    m = np.concatenate([np.asarray(cols[k], np.float64).reshape(
        len(cols[k]), -1) for k in sorted(cols)], axis=1)
    return m[np.lexsort(m.T[::-1])]


@pytest.fixture(scope="module")
def episodes(tmp_path_factory):
    def behavior(obs, r):
        return int(r.integers(4)) if r.random() < 0.3 \
            else int(np.argmax(obs))
    path = str(tmp_path_factory.mktemp("episodes") / "guess.npz")
    trl.collect_from_env("StatelessGuess", behavior, 600, path, seed=0)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _inputs(source, episodes, tmp_path):
    """(JAX's input_path, the port's) for ``source``."""
    if source == "parquet":
        return (jrl.save_parquet(str(tmp_path / "jax"), episodes),
                trl.save_parquet(str(tmp_path / "port"), episodes))
    import ray_tpu.data as jdata
    from ray_tpu_torch import data as tdata
    return (jdata.from_numpy(episodes, parallelism=3),
            tdata.from_numpy(episodes, parallelism=3))


@pytest.mark.parametrize("source", ["parquet", "dataset"])
@pytest.mark.parametrize("name", ["BC", "MARWIL", "CQL"])
def test_offline_update_from_source_matches_jax(name, source, episodes,
                                                tmp_path):
    j_in, t_in = _inputs(source, episodes, tmp_path)

    def cfg(c, path):
        c = (c.environment("StatelessGuess")
             .offline_data(input_path=path, updates_per_iteration=3)
             .training(lr=1e-3).debugging(seed=5))
        return c.training(target_update_freq=2) if name == "CQL" else c
    j = cfg(getattr(jrl, name + "Config")(), j_in).build_algo()
    t = cfg(getattr(trl, name + "Config")(), t_in).resources(
        device=CPU).build_algo()
    # Both read back the episodes, in order (the obs columns stacked from
    # parquet's ``obs/<i>``).
    for k, v in episodes.items():
        np.testing.assert_array_equal(t.data.columns[k], v)
        np.testing.assert_array_equal(j.data.columns[k], v)
    _same_start(j, t)
    jm, tm = j.training_step(), t.training_step()
    for k in jm["learner"]:
        close(tm["learner"][k], jm["learner"][k], what=k)
    trees_close(t.get_weights(), j.get_weights(), whole_tree=True)


def test_parquet_written_by_one_package_reads_in_the_other(episodes,
                                                           tmp_path):
    jdir = jrl.save_parquet(str(tmp_path / "jax"), episodes)
    tdir = trl.save_parquet(str(tmp_path / "port"), episodes)
    for path in (jdir, tdir):
        got_t = trl.OfflineData(path).columns
        got_j = jrl.OfflineData(path).columns
        assert sorted(got_t) == sorted(got_j) == sorted(episodes)
        for k in episodes:
            np.testing.assert_array_equal(got_t[k], got_j[k])
            assert got_t[k].dtype == got_j[k].dtype


def test_parquet_under_a_task_session(episodes, tmp_path):
    """Under a task session the shards are written by tasks and read back
    as blocks arrive, so the rows equal the episodes as a multiset."""
    from ray_tpu_torch import _tasks
    rtt.init(num_cpus=2)
    try:
        before = _tasks.stats().get("tasks_run", 0)
        tdir = trl.save_parquet(str(tmp_path / "port"), episodes, shards=4)
        assert _tasks.stats()["tasks_run"] - before == 4   # the writes
        cols = trl.OfflineData(tdir).columns
    finally:
        rtt.shutdown()
    assert sorted(cols) == sorted(episodes)
    np.testing.assert_array_equal(_sorted_rows(cols), _sorted_rows(episodes))
