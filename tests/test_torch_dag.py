"""Compiled graphs over the port's actors (``ray_tpu_torch.dag``) against
the JAX package's ``ray_tpu.dag``.

Every case of ``tests/test_dag.py`` runs as one scenario through both
packages: the JAX side under the conftest ``ray_start`` runtime with its
actors, the port's over ``_actor`` processes on the CPU.  Each scenario
returns what it observed (values, error texts, channel counts) and the two
packages' returns must be equal.  Then ``_tree_reduce`` of both packages
on the same seeded mixed trees, for sum, mean, max and min: equal for
integers, fp32 within rtol 1e-6 (the port reduces torch tensors in torch).

The port's actors are started once for the file (a spawned actor imports
torch, seconds each) and reused: a compiled DAG's teardown leaves its
actors serving calls.  The JAX package is imported inside functions: each
port actor imports this file.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

from ray_tpu_torch import _actor as A

ONE_THREAD = {"num_cpus": 1, "env_vars": {"OMP_NUM_THREADS": "1"},
              "device": "cpu"}
TIMEOUT = 30


class Node:
    """Every actor of test_dag.py in one plain class (both packages'
    ``remote`` wrap it): ``inc`` is Adder's increment, Shard's scale and
    P's k; ``fail`` is Flaky's flag."""

    def __init__(self, inc=1, fail=False):
        self.inc = inc
        self.fail = fail
        self.calls = 0

    def add(self, x):
        self.calls += 1
        return x + self.inc

    def add2(self, a, b):
        return a + b

    def boom(self, x):
        raise ValueError("kapow")

    def grad(self, x):
        return np.asarray(x, np.float32) * self.inc

    def norm(self, g):
        return float(np.sum(g))

    def make(self, x):
        return {"a": np.full(2, self.inc, np.float32),
                "b": float(self.inc * 10)}

    def read(self, t):
        return (t["a"].tolist(), t["b"])

    def flaky(self, x):
        if self.fail and x > 1:
            raise RuntimeError("shard exploded")
        return np.ones(2, np.float32)

    def fast(self, x):
        return x

    def slow(self, x):
        time.sleep(1.0)
        return x * 10


def times_k(instance, k):
    """TestRayCall's function (module level: the port pickles by
    reference)."""
    return instance.inc * k


#: The actors a scenario asks for by name: (inc, fail).
SPECS = {"n1": (1, False), "n10": (10, False), "n2": (2, False),
         "n3": (3, False), "n0": (0, False), "nf": (1, True)}


class _Pkg:
    """One package's face for a scenario: its dag module, get, TaskError
    and actors by name."""

    def __init__(self, name, dag, get, task_error, actors):
        self.name = name
        self.dag = dag
        self.get = get
        self.TaskError = task_error
        self._actors = actors

    def actors(self, *names):
        return [self._actors(n) for n in names]


@pytest.fixture(scope="module")
def port_pkg():
    import ray_tpu_torch.dag as dag
    cls = A.remote(Node)
    handles = {n: cls.options(**ONE_THREAD).remote(*SPECS[n])
               for n in SPECS}
    A.get([h.add.remote(0) for h in handles.values()], timeout=300)
    yield _Pkg("port", dag, A.get, A.TaskError, handles.__getitem__)
    for h in handles.values():
        A.kill(h)


@pytest.fixture
def jax_pkg(request):
    request.getfixturevalue("ray_start")
    import ray_tpu
    import ray_tpu.dag as dag
    cls = ray_tpu.remote(Node)
    return _Pkg("jax", dag, ray_tpu.get, ray_tpu.TaskError,
                lambda n: cls.remote(*SPECS[n]))


def both(jax_pkg, port_pkg, scenario):
    """The scenario's observations under each package; they must agree."""
    want = scenario(jax_pkg)
    got = scenario(port_pkg)
    assert got == want, (got, want)
    return got


def _err(fn):
    """The text of what ``fn`` raised (None if it did not)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the scenario records it
        return type(e).__name__ if not str(e) else str(e).split("\n")[0]
    return None


# -- channels ------------------------------------------------------------------


def _channel_mod(which):
    if which == "jax":
        from ray_tpu.dag import channel
        return channel
    from ray_tpu_torch.dag import channel
    return channel


def _roundtrip(ch_mod):
    ch = ch_mod.ShmChannel(1024)
    ch.write(b"hello")
    first = ch.read()
    ch.write(b"", ch_mod.FLAG_STOP)
    second = ch.read()[0]
    ch.close()
    ch.unlink()
    return first, second


def _backpressure(ch_mod):
    ch = ch_mod.ShmChannel(64)
    ch.write(b"one")
    timed_out = _err(lambda: ch.write(b"two", timeout=0.05))
    out = [ch.read()[1]]
    ch.write(b"two")
    out.append(ch.read()[1])
    too_big = _err(lambda: ch.write(b"x" * 65))
    ch.close()
    ch.unlink()
    return timed_out, out, too_big


class TestShmChannel:
    def test_roundtrip(self):
        got = _roundtrip(_channel_mod("port"))
        assert got == _roundtrip(_channel_mod("jax"))
        assert got == ((0, b"hello"), 1)

    def test_backpressure_and_timeout(self):
        got = _backpressure(_channel_mod("port"))
        assert got == _backpressure(_channel_mod("jax"))
        assert got[0].startswith("timed out") and got[1] == [b"one",
                                                             b"two"]


# -- interpreted ----------------------------------------------------------------


class TestInterpretedDag:
    def test_chain(self, jax_pkg, port_pkg):
        def run(p):
            a, b = p.actors("n1", "n10")
            with p.dag.InputNode() as inp:
                dag = b.add.bind(a.add.bind(inp))
            return p.get(dag.execute(5))
        assert both(jax_pkg, port_pkg, run) == 16

    def test_multi_output_and_input_attr(self, jax_pkg, port_pkg):
        def run(p):
            a, b = p.actors("n1", "n2")
            with p.dag.InputNode() as inp:
                dag = p.dag.MultiOutputNode([a.add.bind(inp[0]),
                                             b.add.bind(inp[1])])
            return p.get(dag.execute(10, 20))
        assert both(jax_pkg, port_pkg, run) == [11, 22]


# -- compiled -------------------------------------------------------------------


def _compiled(p, node, fn, **kw):
    compiled = node.experimental_compile(**kw)
    try:
        return fn(compiled)
    finally:
        compiled.teardown()


class TestCompiledDag:
    def test_linear_pipeline(self, jax_pkg, port_pkg):
        def run(p):
            a, b = p.actors("n1", "n10")
            with p.dag.InputNode() as inp:
                dag = b.add.bind(a.add.bind(inp))
            return _compiled(p, dag, lambda c: [
                c.execute(i).get(timeout=TIMEOUT) for i in range(5)])
        assert both(jax_pkg, port_pkg, run) == [11, 12, 13, 14, 15]

    def test_fan_out_fan_in(self, jax_pkg, port_pkg):
        def run(p):
            a, b, c = p.actors("n1", "n2", "n0")
            with p.dag.InputNode() as inp:
                dag = c.add2.bind(a.add.bind(inp), b.add.bind(inp))
            return _compiled(p, dag, lambda g: [
                g.execute(5).get(timeout=TIMEOUT),
                g.execute(0).get(timeout=TIMEOUT)])
        assert both(jax_pkg, port_pkg, run) == [13, 3]

    def test_multi_output(self, jax_pkg, port_pkg):
        def run(p):
            a, b = p.actors("n1", "n2")
            with p.dag.InputNode() as inp:
                dag = p.dag.MultiOutputNode([a.add.bind(inp),
                                             b.add.bind(inp)])
            return _compiled(p, dag,
                             lambda c: c.execute(1).get(timeout=TIMEOUT))
        assert both(jax_pkg, port_pkg, run) == [2, 3]

    def test_intra_actor_locality(self, jax_pkg, port_pkg):
        def run(p):
            (a,) = p.actors("n1")
            with p.dag.InputNode() as inp:
                dag = a.add.bind(a.add.bind(inp))
            # Two stages on one actor: values pass locally, no channel.
            return _compiled(p, dag, lambda c: (
                c.execute(0).get(timeout=TIMEOUT), len(c._channels)))
        assert both(jax_pkg, port_pkg, run) == (2, 2)

    def test_pipelined_executions(self, jax_pkg, port_pkg):
        def run(p):
            (a,) = p.actors("n1")
            with p.dag.InputNode() as inp:
                dag = a.add.bind(inp)

            def go(c):
                refs = [c.execute(i) for i in range(2)]
                return [r.get(timeout=TIMEOUT) for r in refs]
            return _compiled(p, dag, go)
        assert both(jax_pkg, port_pkg, run) == [1, 2]

    def test_error_propagation_keeps_pipeline_alive(self, jax_pkg,
                                                    port_pkg):
        def run(p):
            a, b = p.actors("n1", "n2")
            with p.dag.InputNode() as inp:
                dag = b.add.bind(a.boom.bind(inp))

            def go(c):
                # The loop survives an application error.
                return [("kapow" in str(_err(
                    lambda: c.execute(i).get(timeout=TIMEOUT))))
                    for i in (1, 2)]
            return _compiled(p, dag, go)
        assert both(jax_pkg, port_pkg, run) == [True, True]

    def test_numpy_payload(self, jax_pkg, port_pkg):
        arr = np.random.default_rng(0).standard_normal(
            (256, 256)).astype(np.float32)

        def run(p):
            (a,) = p.actors("n1")
            with p.dag.InputNode() as inp:
                dag = a.add.bind(inp)
            out = _compiled(p, dag, lambda c: c.execute(arr).get(
                timeout=TIMEOUT), buffer_size_bytes=1 << 22)
            return out.dtype.name, out.tobytes()
        got = both(jax_pkg, port_pkg, run)
        np.testing.assert_array_equal(np.frombuffer(got[1], np.float32),
                                      (arr + 1).ravel())

    def test_actor_usable_after_teardown(self, jax_pkg, port_pkg):
        def run(p):
            (a,) = p.actors("n1")
            with p.dag.InputNode() as inp:
                dag = a.add.bind(inp)
            compiled = dag.experimental_compile()
            first = compiled.execute(1).get(timeout=TIMEOUT)
            compiled.teardown()
            # The loop has exited; the actor serves ordinary calls again.
            after = p.get(a.add.remote(41), timeout=TIMEOUT)
            return first, after, _err(lambda: compiled.execute(1))
        assert both(jax_pkg, port_pkg, run) == (
            2, 42, "compiled DAG has been torn down")

    def test_compile_validations(self, jax_pkg, port_pkg):
        def run(p):
            (a,) = p.actors("n1")
            with p.dag.InputNode():
                dag_no_input = a.add.bind(7)
            return "depend on the InputNode" in str(
                _err(dag_no_input.experimental_compile))
        assert both(jax_pkg, port_pkg, run) is True


class TestRayCall:
    def test_ray_call_apply(self, jax_pkg, port_pkg):
        def run(p):
            (a,) = p.actors("n10")
            return p.get(a.__ray_call__.remote(times_k, 4), timeout=TIMEOUT)
        assert both(jax_pkg, port_pkg, run) == 40


class TestRevisitActorTopology:
    def test_actor_revisited_after_other_actor(self, jax_pkg, port_pkg):
        def run(p):
            a, b = p.actors("n1", "n10")
            with p.dag.InputNode() as inp:
                x = a.add.bind(inp)          # runs on A
                y = b.add.bind(x)            # runs on B
                dag = a.add2.bind(x, y)      # back on A, needs B's output
            return _compiled(p, dag, lambda c: [
                c.execute(5).get(timeout=TIMEOUT),
                c.execute(0).get(timeout=TIMEOUT)])
        assert both(jax_pkg, port_pkg, run) == [22, 12]


class TestTeardownSemantics:
    def test_get_after_teardown_returns_drained_result(self, jax_pkg,
                                                       port_pkg):
        def run(p):
            (a,) = p.actors("n1")
            with p.dag.InputNode() as inp:
                dag = a.add.bind(inp)
            compiled = dag.experimental_compile()
            ref = compiled.execute(4)
            compiled.teardown()
            # Drained into the cache during teardown.
            return ref.get(timeout=5)
        assert both(jax_pkg, port_pkg, run) == 5

    def test_get_timeout_does_not_desync_outputs(self, jax_pkg, port_pkg):
        def run(p):
            f, s = p.actors("n1", "n2")
            with p.dag.InputNode() as inp:
                dag = p.dag.MultiOutputNode([f.fast.bind(inp),
                                             s.slow.bind(inp)])

            def go(c):
                ref = c.execute(3)
                timed_out = isinstance(_fetch_error(ref), TimeoutError)
                # The retry succeeds with outputs correctly paired.
                return timed_out, ref.get(timeout=TIMEOUT)
            return _compiled(p, dag, go)
        assert both(jax_pkg, port_pkg, run) == (True, [3, 30])


def _fetch_error(ref):
    try:
        ref._dag._fetch(0, timeout=0.1)
    except Exception as e:  # noqa: BLE001 - the scenario records it
        return e
    return None


# -- collectives ----------------------------------------------------------------


class TestCollectiveNodes:
    def _sum_norms(self, p, compiled_iters=None):
        w = p.actors("n1", "n2", "n3")
        with p.dag.InputNode() as inp:
            grads = [wi.grad.bind(inp) for wi in w]
            red = p.dag.allreduce_bind(grads, op="sum")
            node = p.dag.MultiOutputNode(
                [wi.norm.bind(r) for wi, r in zip(w, red)])
        if compiled_iters is None:
            return p.get(node.execute(np.ones(4)))
        return _compiled(p, node, lambda c: [
            c.execute(np.full(4, t + 1.0)).get(timeout=TIMEOUT)
            for t in range(compiled_iters)])

    def test_interpreted_allreduce(self, jax_pkg, port_pkg):
        assert both(jax_pkg, port_pkg, self._sum_norms) == [24.0] * 3

    def test_compiled_allreduce_many_iterations(self, jax_pkg, port_pkg):
        got = both(jax_pkg, port_pkg,
                   lambda p: self._sum_norms(p, compiled_iters=5))
        assert got == [[24.0 * (t + 1)] * 3 for t in range(5)]

    def test_compiled_mean_over_pytree(self, jax_pkg, port_pkg):
        def run(p):
            w = p.actors("n1", "n3")
            with p.dag.InputNode() as inp:
                parts = [wi.make.bind(inp) for wi in w]
                red = p.dag.allreduce_bind(parts, op="mean")
                node = p.dag.MultiOutputNode(
                    [wi.read.bind(r) for wi, r in zip(w, red)])
            return _compiled(p, node,
                             lambda c: c.execute(0).get(timeout=TIMEOUT))
        assert both(jax_pkg, port_pkg, run) == [([2.0, 2.0], 20.0)] * 2

    def test_validation(self, jax_pkg, port_pkg):
        def run(p):
            w = p.actors("n1", "n2")
            with p.dag.InputNode() as inp:
                g0 = w[0].grad.bind(inp)
                g1 = w[1].grad.bind(inp)
                same = w[0].grad.bind(inp)
            out = [_err(lambda: p.dag.allreduce_bind([g0, same])),
                   _err(lambda: p.dag.allreduce_bind([g0])),
                   _err(lambda: p.dag.allreduce_bind([g0, g1], op="xor"))]
            red = p.dag.allreduce_bind([g0, g1], op="sum")
            only = w[0].norm.bind(red[0])
            out.append(_err(only.experimental_compile))
            return out
        got = both(jax_pkg, port_pkg, run)
        for text, want in zip(got, ("distinct actors", "participants",
                                    "unsupported", "outputs of a "
                                    "collective")):
            assert want in text

    def test_error_propagates_through_collective(self, jax_pkg, port_pkg):
        def run(p):
            w = p.actors("n1", "nf")
            with p.dag.InputNode() as inp:
                grads = [wi.flaky.bind(inp) for wi in w]
                red = p.dag.allreduce_bind(grads, op="sum")
                node = p.dag.MultiOutputNode(
                    [wi.norm.bind(r) for wi, r in zip(w, red)])

            def go(c):
                first = c.execute(0).get(timeout=TIMEOUT)
                try:
                    c.execute(5).get(timeout=TIMEOUT)
                    err = None
                except p.TaskError as e:
                    err = "shard exploded" in str(e)
                # The pipeline stays usable after the error iteration.
                return first, err, c.execute(1).get(timeout=TIMEOUT)
            return _compiled(p, node, go)
        assert both(jax_pkg, port_pkg, run) == ([4.0, 4.0], True,
                                                [4.0, 4.0])


# -- _tree_reduce against JAX's ---------------------------------------------------


def _mixed_trees(seed, n=3):
    """n same-structure trees of fp32 and int32 arrays, Python floats and
    ints, in dicts, lists and tuples."""
    rng = np.random.default_rng(seed)
    return [{"w": rng.standard_normal((4, 3)).astype(np.float32),
             "layers": [rng.integers(-50, 50, (5,)).astype(np.int32),
                        (float(rng.standard_normal()),
                         int(rng.integers(-9, 9)))],
             "b": rng.standard_normal((7,)).astype(np.float32)}
            for _ in range(n)]


@pytest.mark.parametrize("as_tensors", [False, True],
                         ids=["numpy", "torch"])
@pytest.mark.parametrize("op", ["sum", "mean", "max", "min"])
def test_tree_reduce_matches_jax(op, as_tensors):
    import torch
    from ray_tpu.dag.collective import _tree_reduce as jax_reduce
    from ray_tpu_torch._tree import tree_leaves, tree_map
    from ray_tpu_torch.dag.collective import _tree_reduce
    trees = _mixed_trees(3)
    want = jax_reduce(op, trees)
    if as_tensors:
        trees = [tree_map(lambda x: torch.from_numpy(x)
                          if isinstance(x, np.ndarray) else x, t)
                 for t in trees]
    got = _tree_reduce(op, trees)
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        if as_tensors and isinstance(g, torch.Tensor):
            g = g.numpy()
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        if np.issubdtype(w.dtype, np.integer) and op != "mean":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6)
