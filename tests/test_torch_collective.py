"""The port's collective groups (``ray_tpu_torch.collective``): a twin of
``tests/test_collective.py`` on the port's process actors, held to the same
numpy expectations as the JAX package's tests.

The KV backend runs its ops and point-to-point over three (and two)
actors; the ``torch.distributed`` backend, under JAX's names ``"xla"`` and
``"gloo"``, runs a 2-process gloo group's allreduce, allgather,
reducescatter, broadcast, reduce, barrier and send/recv.  Each actor runs
torch on one thread.  Every ``get`` has a timeout.
"""

from __future__ import annotations

import numpy as np
import pytest

from ray_tpu_torch import _actor as A
from ray_tpu_torch import collective as col

ONE_THREAD = {"num_cpus": 1, "env_vars": {"OMP_NUM_THREADS": "1"}}


@A.remote
class CollectiveWorker:
    def __init__(self, rank, world):
        self.rank, self.world = rank, world

    def setup(self, group, backend, world=None):
        """Join ``group``; a ``world`` smaller than the actors' takes the
        first ``world`` of them."""
        col.init_collective_group(world or self.world, self.rank,
                                  backend=backend, group_name=group)
        return True

    def run_ops(self, group):
        world = col.get_collective_group_size(group)
        out = {}
        x = np.full(4, float(self.rank + 1), np.float32)
        out["allreduce"] = col.allreduce(x, group)
        out["allreduce_max"] = col.allreduce(x, group, op=col.MAX)
        out["allgather"] = col.allgather(
            np.array([self.rank], np.float32), group)
        out["broadcast"] = col.broadcast(
            np.full(2, float(self.rank), np.float32), src_rank=1,
            group_name=group)
        rs_in = np.arange(world * 2, dtype=np.float32)
        out["reducescatter"] = col.reducescatter(rs_in, group)
        out["reduce"] = col.reduce(x, dst_rank=0, group_name=group)
        col.barrier(group)
        out["rank"] = col.get_rank(group)
        out["size"] = col.get_collective_group_size(group)
        return out

    def p2p(self, group):
        if self.rank == 0:
            col.send(np.array([42.0], np.float32), dst_rank=1,
                     group_name=group)
            col.send(np.array([43.0], np.float32), dst_rank=1,
                     group_name=group)
            return None
        return [col.recv((1,), np.float32, src_rank=0, group_name=group)
                for _ in range(2)]

    def destroy(self, group):
        col.destroy_collective_group(group)
        return col.is_group_initialized(group)


def _check_ops(results, world):
    for r, res in enumerate(results):
        total = world * (world + 1) / 2
        np.testing.assert_allclose(res["allreduce"], np.full(4, total))
        np.testing.assert_allclose(res["allreduce_max"], np.full(4, world))
        np.testing.assert_allclose(res["allgather"],
                                   [[i] for i in range(world)])
        np.testing.assert_allclose(res["broadcast"], [1.0, 1.0])
        np.testing.assert_allclose(
            res["reducescatter"],
            world * np.arange(world * 2, dtype=np.float32)[r * 2:
                                                           (r + 1) * 2])
        want_reduce = np.full(4, total) if r == 0 else np.full(4, r + 1.0)
        np.testing.assert_allclose(res["reduce"], want_reduce)
        assert res["rank"] == r and res["size"] == world


@pytest.fixture(scope="module")
def workers():
    """Three CPU actors, shared by the tests of this file."""
    ws = [CollectiveWorker.options(**ONE_THREAD).remote(r, 3)
          for r in range(3)]
    yield ws
    for w in ws:
        A.kill(w)


def test_kv_backend_all_ops(workers):
    assert all(A.get([w.setup.remote("kv1", "kv") for w in workers],
                     timeout=120))
    _check_ops(A.get([w.run_ops.remote("kv1") for w in workers],
                     timeout=60), 3)
    assert A.get([w.destroy.remote("kv1") for w in workers],
                 timeout=60) == [False] * 3


@pytest.mark.parametrize("backend", ["xla", "gloo"])
def test_two_process_gloo_ops(workers, backend):
    """JAX's 2-process allreduce and allgather (tests/test_collective.py
    TestXlaBackend), and the other ops, over a gloo process group of the
    first two actors."""
    pair, group = workers[:2], f"g_{backend}"
    assert A.get([w.setup.remote(group, backend, 2) for w in pair],
                 timeout=120) == [True, True]
    _check_ops(A.get([w.run_ops.remote(group) for w in pair], timeout=60),
               2)
    A.get([w.destroy.remote(group) for w in pair], timeout=60)


@pytest.mark.parametrize("backend", ["kv", "xla"])
def test_p2p(workers, backend):
    """send/recv through the group, twice, in order."""
    pair, group = workers[:2], f"p2p_{backend}"
    A.get([w.setup.remote(group, backend, 2) for w in pair], timeout=120)
    out = A.get([w.p2p.remote(group) for w in pair], timeout=60)
    assert out[0] is None
    np.testing.assert_allclose(np.concatenate(out[1]), [42.0, 43.0])
    A.get([w.destroy.remote(group) for w in pair], timeout=60)


def test_group_remade_under_its_name_and_two_groups_in_one_process(workers):
    """A destroyed group's name forms a fresh group (a new nonce, so no
    earlier round is read); a kv and a gloo group live in one process."""
    pair = workers[:2]
    for _ in range(2):
        A.get([w.setup.remote("again", "gloo", 2) for w in pair],
              timeout=120)
        A.get([w.setup.remote("again_kv", "kv", 2) for w in pair],
              timeout=120)
        for group in ("again", "again_kv"):
            _check_ops(A.get([w.run_ops.remote(group) for w in pair],
                             timeout=60), 2)
        A.get([w.destroy.remote(g) for w in pair
               for g in ("again", "again_kv")], timeout=60)


def test_errors_in_this_process():
    with pytest.raises(ValueError, match="not initialized"):
        col.allreduce(np.ones(2), "no_such_group")
    with pytest.raises(ValueError, match="unknown collective backend"):
        col.init_collective_group(1, 0, backend="mpi", group_name="x")
    # A one-member group forms in the test process itself.
    col.init_collective_group(1, 0, backend="gloo", group_name="solo")
    try:
        with pytest.raises(ValueError, match="already initialized"):
            col.init_collective_group(1, 0, group_name="solo")
        np.testing.assert_array_equal(
            col.allgather(np.arange(3, dtype=np.int64), "solo"),
            [np.arange(3)])
    finally:
        col.destroy_collective_group("solo")
    assert not col.is_group_initialized("solo")
