"""The port's scheduler tier (``ray_tpu_torch._scheduler``, its card grant,
and the task and actor options that book through it) against JAX's.

- One scripted sequence (submissions, a dependency, placement groups under
  all four strategies, node affinity hard and soft, infeasible asks,
  releases) drives JAX's ``ClusterScheduler`` and the port's, each on a
  one-node table of ``{CPU: 4, card: 2, custom: 1}`` (JAX's card is
  ``TPU``, the port's ``GPU``).  The dispatch order, the placement groups'
  states and bundle locations, the card grants (JAX's node grants chips
  from its pool as ``node.py:640-650`` does; the port's ``Node``) and each
  task's decision kinds and rejection reasons must be equal.
- JAX's ``tests/test_accelerator_abc.py`` cases against
  ``CUDAAcceleratorManager``, with a fake ``/proc`` directory and a fake
  ``CUDA_VISIBLE_DEVICES``; ``util.gpu``'s card reservation.
- Through the task and actor tiers: grants pinned by
  ``CUDA_VISIBLE_DEVICES`` (over the parent's list), a retried task's fresh
  grant, an infeasible ask parked and never run, a task inside a placement
  group while one outside waits for its removal, ``get_actor`` by name, an
  actor booked with a card, nested tasks giving 201 on both packages, and
  201 on a one-CPU node (the worker blocked in ``get`` gives up its CPU).

The task functions are module-level (the port's workers import this file);
it imports neither torch nor JAX at the top.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import pytest

import ray_tpu_torch as rtt

TIMEOUT = 60
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the scripted sequence through both schedulers ------------------------------


class _Side:
    """One package's scheduler on a one-node table, driven by name."""

    def __init__(self, pkg: str):
        self.pkg = pkg
        if pkg == "jax":
            from ray_tpu._private import controller as c
            from ray_tpu._private import ids, resources
            from ray_tpu._private import scheduler as s
            from ray_tpu._private.protocol import TaskSpec
            self.card = "TPU"
            self.controller = c.Controller()
            self.ids, self.R, self.s, self.c = ids, resources.ResourceSet, s, c
            self.info = c.NodeInfo(ids.NodeID.from_random(), "host",
                                   self.R({"CPU": 4, "TPU": 2, "custom": 1}))
            self.controller.register_node(self.info)
            self.futures = {}
            self.sched = s.ClusterScheduler(
                self.controller, lambda oid: self.futures.get(oid, True))
            self.sched.add_node(self.info)
            self._spec = lambda **kw: TaskSpec(
                fn_blob=None, method_name=None, kwarg_descs={},
                return_ids=[], **kw)
            self._pool = [0, 1]
        else:
            from ray_tpu_torch import _ids as ids
            from ray_tpu_torch import _resources as resources
            from ray_tpu_torch import _scheduler as s
            self.card = "GPU"
            self.node = s.Node(4, num_tpus=2, resources={"custom": 1})
            self.controller = self.node.controller
            self.ids, self.R, self.s, self.c = ids, resources.ResourceSet, \
                s, s
            self.info = self.node.info
            self.sched = self.node.scheduler
            self.futures = None
            self._spec = lambda **kw: s.TaskSpec(
                fn_blob=None, method_name=None, kwarg_descs={},
                return_ids=[], **kw)
        self.dispatched = []
        self.grants = {}
        self.specs = {}
        self.pgs = {}
        self.deps = {}

    def res(self, d):
        return self.R({(self.card if k == "card" else k): v
                       for k, v in d.items()})

    def _grant(self, spec):
        n = int(spec.resources.get(self.card))
        if self.pkg == "jax":
            grant = self._pool[:n] if n > 0 else []
            del self._pool[:len(grant)]
            return grant
        return self.node.take_cards(spec)

    def submit(self, name, res, strategy=None, pg=None, bundle=-1,
               dep=None):
        args = []
        if dep is not None:
            oid = self.ids.ObjectID.from_random()
            if self.pkg == "jax":
                self.futures[oid] = False
            else:
                import concurrent.futures as cf
                fut = cf.Future()
                self.node._deps[oid] = fut
                self.futures = self.futures or {}
                self.futures[oid] = fut
            self.deps[dep] = oid
            args = [("ref", oid)]
        if isinstance(strategy, tuple):   # ("affinity", soft, known node)
            _, soft, known = strategy
            nid = self.info.node_id if known else self.ids.NodeID.from_random()
            strategy = self.s.NodeAffinitySchedulingStrategy(nid, soft=soft)
        spec = self._spec(task_id=self.ids.TaskID.from_random(), name=name,
                          arg_descs=args, resources=self.res(res),
                          placement_group=self.pgs.get(pg), bundle_index=bundle,
                          scheduling_strategy=strategy)
        self.specs[name] = spec

        def dispatch(spec, node_id):
            self.grants[spec.name] = self._grant(spec)
            self.dispatched.append(spec.name)

        self.sched.submit(spec, dispatch)

    def resolve(self, dep):
        oid = self.deps[dep]
        if self.pkg == "jax":
            self.futures[oid] = True
        else:
            self.futures[oid].set_result(None)
        self.sched.notify_object_ready(oid)

    def release(self, name):
        spec = self.specs[name]
        if self.pkg == "jax":
            self._pool = sorted(self._pool + self.grants[name])
            self.sched.release(self.info.node_id, spec.resources,
                               spec.placement_group, spec.bundle_index)
        else:
            self.node.give_back(spec, self.grants[name])

    def create_pg(self, key, bundles, strategy):
        bundles = [self.res(b).to_dict() for b in bundles]
        pg_id = self.ids.PlacementGroupID.of(self.ids.JobID.from_int(1))
        info = self.c.PlacementGroupInfo(
            pg_id, key, strategy,
            [self.c.BundleInfo(i, self.R(b)) for i, b in enumerate(bundles)])
        self.controller.register_placement_group(info)
        self.sched.create_placement_group(info)
        self.pgs[key] = pg_id

    def remove_pg(self, key):
        self.sched.remove_placement_group(
            self.controller.get_placement_group(self.pgs[key]))

    def settle(self):
        """Until the scheduler is quiet (nothing new dispatched, queues
        unchanged) for 1 s: its loop wakes on every release, and a loaded
        host may hold it off for a while."""
        last, quiet = None, time.monotonic()
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            now = (len(self.dispatched), tuple(sorted(
                self.sched.queue_depths().items())))
            if now != last:
                last, quiet = now, time.monotonic()
            elif time.monotonic() - quiet > 1.0:
                return
            time.sleep(0.02)

    def observe(self):
        self.settle()
        node = self.info.node_id
        pgs = {}
        for key, pg_id in self.pgs.items():
            info = self.controller.get_placement_group(pg_id)
            pgs[key] = (info.state, [("node" if b.node_id == node else
                                      b.node_id) for b in info.bundles])
        avail = {("card" if k == self.card else k): v
                 for k, v in self.sched.available_resources().items()
                 if k != "memory"}
        return {"dispatched": list(self.dispatched),
                "grants": dict(self.grants), "pgs": pgs,
                "available": avail,
                "depths": self.sched.queue_depths()}

    def decisions(self):
        by_task = {}
        names = {s.task_id.hex(): n for n, s in self.specs.items()}
        for rec in self.sched.ring.snapshot(limit=10_000):
            name = names.get(rec["task_id"], rec["name"])
            kinds, reasons = by_task.setdefault(name, (set(), set()))
            kinds.add(rec["kind"])
            reasons.update(rec["rejected"])
        return {k: (sorted(v[0]), sorted(v[1])) for k, v in by_task.items()}


def _script(side: _Side):
    obs = []
    side.submit("t1", {"CPU": 2})
    side.submit("t2", {"CPU": 1, "card": 1})
    side.submit("t3", {"CPU": 1, "card": 2})                  # waits: cards
    obs.append(side.observe())
    side.create_pg("pack", [{"CPU": 1}, {"card": 1}], "STRICT_PACK")
    side.submit("in_pg", {"card": 1}, pg="pack", bundle=1)
    side.submit("hard_miss", {"CPU": 1}, strategy=("affinity", False, False))
    side.submit("soft_miss", {"custom": 1, "CPU": 0},
                strategy=("affinity", True, False))
    side.submit("affine", {"CPU": 0, "custom": 0.5},
                strategy=("affinity", False, True))
    side.submit("infeasible", {"card": 3})
    side.submit("after_dep", {"CPU": 0}, dep="d")
    obs.append(side.observe())
    side.resolve("d")
    side.create_pg("spread2", [{"CPU": 1}, {"CPU": 1}], "STRICT_SPREAD")
    side.create_pg("spread", [{"custom": 0.5}], "SPREAD")
    side.release("t1")
    obs.append(side.observe())
    side.create_pg("packed", [{"CPU": 1}, {"CPU": 0.5}], "PACK")
    side.submit("wild", {"CPU": 0.5}, pg="packed")
    side.release("t2")
    side.release("in_pg")
    obs.append(side.observe())
    side.remove_pg("pack")
    side.submit("spread_task", {"CPU": 0.5}, strategy="SPREAD")
    obs.append(side.observe())
    return obs


def test_scripted_sequence_gives_jax_decisions():
    jax_side, port_side = _Side("jax"), _Side("port")
    try:
        want = _script(jax_side)
        got = _script(port_side)
        assert got == want
        assert port_side.decisions() == jax_side.decisions()
    finally:
        jax_side.sched.stop()
        port_side.sched.stop()
    final = got[-1]
    assert final["pgs"]["pack"][0] == "REMOVED"
    assert final["pgs"]["spread2"][0] == "PENDING"   # one node
    assert final["grants"]["t2"] == [0] and final["grants"]["t3"] == [0, 1]
    d = port_side.decisions()
    assert "infeasible" in d["infeasible"][0]
    assert d["hard_miss"][1] == ["affinity_miss"]
    assert "t3" in final["dispatched"] and "hard_miss" not in \
        final["dispatched"]


# -- the accelerator plugin (JAX's test_accelerator_abc.py) ----------------------


def test_cuda_registered_and_conforms(monkeypatch, tmp_path):
    from ray_tpu_torch.accelerators.accelerator import (AcceleratorManager,
                                                        all_accelerators,
                                                        get_accelerator)
    from ray_tpu_torch.accelerators.cuda import CUDAAcceleratorManager as M
    assert get_accelerator("GPU") is M
    assert M in all_accelerators()
    assert issubclass(M, AcceleratorManager)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert M.visibility_env([0, 2]) == {"CUDA_VISIBLE_DEVICES": "0,2"}
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5,7")
    assert M.visibility_env([0, 2]) == {"CUDA_VISIBLE_DEVICES": "3,7"}
    assert M.detect_num_chips() == 3
    assert M.get_current_process_visible_chips() == [3, 5, 7]
    with pytest.raises(RuntimeError, match="were granted"):
        M.visibility_env([3])
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert M.detect_num_chips() == 0
    # No env: the driver's /proc entries, one directory a card.
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    proc = tmp_path / "gpus"
    for bus in ("0000:18:00.0", "0000:2a:00.0"):
        (proc / bus).mkdir(parents=True)
        (proc / bus / "information").write_text(
            "Model: \t\t NVIDIA H100 80GB HBM3\nIRQ: 1\n")
    monkeypatch.setattr(M, "PROC_GPUS", str(proc))
    assert M.detect_num_chips() == 2
    assert M.card_name() == "NVIDIA H100 80GB HBM3"
    assert M.accelerator_type() == "H100"
    assert M.type_from_name("Tesla V100-SXM2-16GB") == "V100"
    assert M.type_from_name("NVIDIA A100-SXM4-80GB") == "A100"
    assert M.slice_resources("H100") == {}
    from ray_tpu_torch.accelerators.cuda import get_tpu_coordinator_env_vars
    with pytest.raises(NotImplementedError, match="multi-slice"):
        get_tpu_coordinator_env_vars(0, 2, "h:1")


def test_custom_accelerator_plugs_in_and_unnamed_rejected():
    from ray_tpu_torch.accelerators import accelerator as mod

    class FakeNPU(mod.AcceleratorManager):
        resource_name = "NPU"

        @staticmethod
        def detect_num_chips() -> int:
            return 2

        @staticmethod
        def visibility_env(chip_ids):
            return {"NPU_VISIBLE": ",".join(map(str, chip_ids))}

    class Bad(mod.AcceleratorManager):
        @staticmethod
        def detect_num_chips() -> int:
            return 0

        @staticmethod
        def visibility_env(chip_ids):
            return {}

    mod.register_accelerator(FakeNPU)
    try:
        assert mod.get_accelerator("NPU") is FakeNPU
        # A node advertises every registered family's chips.
        from ray_tpu_torch._scheduler import Node
        node = Node(1, num_tpus=0)
        assert node.cluster_resources()["NPU"] == 2.0
        node.stop()
    finally:
        mod._REGISTRY.pop("NPU", None)
    with pytest.raises(ValueError):
        mod.register_accelerator(Bad)


def test_card_reservation_one_bundle_per_host(monkeypatch):
    from ray_tpu_torch.util import gpu
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,2,3")
    assert gpu.get_num_cards_per_host() == 4
    assert gpu.get_card_worker_resources() == [{"GPU": 4.0}]
    with pytest.raises(NotImplementedError, match="item 13"):
        gpu.get_card_worker_resources(num_hosts=2)
    session = rtt.init(num_cpus=1, num_tpus=4)
    try:
        res = gpu.card_placement_group()
        assert res.ready(timeout=TIMEOUT)
        assert res.total_hosts == 1 and res.cards_per_host == 4
        assert rtt.available_resources().get("GPU", 0.0) == 0.0
        assert len(res.placement_groups[0].bundle_locations()) == 1
        res.remove()
        assert rtt.available_resources()["GPU"] == 4.0
        with pytest.raises(NotImplementedError, match="item 13"):
            gpu.card_placement_group(num_hosts=2)
    finally:
        rtt.shutdown()
    assert session.id


# -- through the task and actor tiers ----------------------------------------------


def env_of(key):
    return os.environ.get(key)


def env_after(key, t):
    time.sleep(t)
    return os.environ.get(key), time.monotonic()


def crash_once(marker):
    if not os.path.exists(marker):
        open(marker, "w").close()
        os._exit(1)
    return os.environ.get("CUDA_VISIBLE_DEVICES")


def double(x):
    return x * 2


def pid_of():
    return os.getpid()


def outer():
    return rtt.get(rtt.remote(double).remote(100)) + 1


def outer_jax():
    import ray_tpu
    return ray_tpu.get(ray_tpu.remote(double).remote(100)) + 1


class Probe:
    def env(self, key):
        return os.environ.get(key)


@pytest.fixture(scope="module")
def cards():
    """A session advertising two cards (no card is touched: the tasks read
    their pinning env), with no ``CUDA_VISIBLE_DEVICES`` of this process's
    in the way (grants map over it)."""
    old = os.environ.pop("CUDA_VISIBLE_DEVICES", None)
    s = rtt.init(num_cpus=4, num_tpus=2)
    yield s
    rtt.shutdown()
    if old is not None:
        os.environ["CUDA_VISIBLE_DEVICES"] = old


def test_grants_pin_each_task_to_its_cards(cards):
    one = rtt.remote(num_tpus=1)(env_after)
    a, b = one.remote("CUDA_VISIBLE_DEVICES", 0.5), \
        one.remote("CUDA_VISIBLE_DEVICES", 0.5)
    both = rtt.remote(num_tpus=2)(env_of).remote("CUDA_VISIBLE_DEVICES")
    got = rtt.get([a, b], timeout=TIMEOUT)
    assert sorted(g[0] for g in got) == ["0", "1"]
    # A worker that held a card is not pooled: the next card task runs in
    # a fresh process.
    pids = rtt.get([rtt.remote(num_tpus=1)(pid_of).remote()
                    for _ in range(3)], timeout=TIMEOUT)
    assert len(set(pids)) == 3
    assert rtt.get(both, timeout=TIMEOUT) == "0,1"
    # A task without cards is not pinned.
    assert rtt.get(rtt.remote(env_of).remote("CUDA_VISIBLE_DEVICES"),
                   timeout=TIMEOUT) is None
    assert rtt.available_resources()["GPU"] == 2.0


def test_card_tasks_run_one_after_the_other_on_one_card():
    code = (
        "import ray_tpu_torch as rt\n"
        "from test_torch_sched import env_after\n"
        "rt.init(num_cpus=2, num_tpus=1)\n"
        "f = rt.remote(num_tpus=1)(env_after)\n"
        "a, b = rt.get([f.remote('CUDA_VISIBLE_DEVICES', 1.0),\n"
        "               f.remote('CUDA_VISIBLE_DEVICES', 1.0)], timeout=60)\n"
        "assert abs(a[1] - b[1]) >= 1.0, (a, b)\n"
        "print('cards:', a[0], b[0])\n"
        "rt.shutdown()\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="6",
               PYTHONPATH=os.pathsep.join([os.path.dirname(__file__),
                                           REPO]))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    # Card 0 of the parent's list "6".
    assert "cards: 6 6" in out.stdout


def test_retried_task_gets_a_fresh_grant(cards, tmp_path):
    marker = str(tmp_path / "crashed")
    got = rtt.get(rtt.remote(num_tpus=1, max_retries=2)(crash_once).remote(
        marker), timeout=TIMEOUT)
    assert got in ("0", "1") and os.path.exists(marker)
    deadline = time.monotonic() + TIMEOUT
    while rtt.available_resources().get("GPU") != 2.0 and \
            time.monotonic() < deadline:
        time.sleep(0.02)
    assert rtt.available_resources()["GPU"] == 2.0


def test_infeasible_ask_is_parked_and_never_runs(cards):
    sched = cards.node.scheduler
    ref = rtt.remote(num_tpus=3)(env_of).remote("X")
    deadline = time.monotonic() + TIMEOUT
    while sched.queue_depths()["infeasible"] < 1 and \
            time.monotonic() < deadline:
        time.sleep(0.02)
    assert sched.queue_depths()["infeasible"] >= 1
    kinds = {r["kind"] for r in sched.ring.snapshot(limit=10_000)
             if r["name"] == "env_of"}
    assert "infeasible" in kinds
    with pytest.raises(rtt.GetTimeoutError):
        rtt.get(ref, timeout=0.5)


def test_placement_group_holds_its_card_until_removed(cards):
    pg = rtt.placement_group([{"GPU": 1}, {"GPU": 1}], strategy="PACK")
    assert pg.ready(timeout=TIMEOUT)
    assert len(pg.bundle_locations()) == 2
    inside = rtt.remote(num_cpus=0, num_tpus=1, placement_group=pg,
                        placement_group_bundle_index=0)(env_of)
    assert rtt.get(inside.remote("CUDA_VISIBLE_DEVICES"),
                   timeout=TIMEOUT) in ("0", "1")
    outside = rtt.remote(num_tpus=1)(env_of).remote("CUDA_VISIBLE_DEVICES")
    with pytest.raises(rtt.GetTimeoutError):
        rtt.get(outside, timeout=1.0)
    rtt.remove_placement_group(pg)
    assert rtt.get(outside, timeout=TIMEOUT) in ("0", "1")
    assert not pg.ready(timeout=0)
    assert rtt.nodes()[0]["resources"]["GPU"] == 2.0


def test_named_actor_booked_with_a_card(cards):
    a = rtt.remote(Probe).options(name="probe", num_tpus=1,
                                  env_vars={"OMP_NUM_THREADS": "1"}).remote()
    assert rtt.get(a.env.remote("CUDA_VISIBLE_DEVICES"),
                   timeout=TIMEOUT) in ("0", "1")
    assert rtt.available_resources()["GPU"] == 1.0
    b = rtt.get_actor("probe")
    assert b._actor_id == a._actor_id
    assert rtt.get(b.env.remote("OMP_NUM_THREADS"), timeout=TIMEOUT) == "1"
    with pytest.raises(ValueError, match="no actor named"):
        rtt.get_actor("probe", namespace="elsewhere")
    rtt.kill(a)
    deadline = time.monotonic() + TIMEOUT
    while rtt.available_resources()["GPU"] != 2.0 and \
            time.monotonic() < deadline:
        time.sleep(0.02)
    assert rtt.available_resources()["GPU"] == 2.0
    with pytest.raises(ValueError, match="died"):
        rtt.get_actor("probe")


def test_nested_tasks_give_201_on_both(cards):
    """JAX's ``test_nested_tasks`` on both packages.  The port's part runs
    first: JAX's leak sanitizer counts threads started from this tree
    while its runtime is up, and the port's session outlives this test."""
    assert rtt.get(rtt.remote(outer).remote(), timeout=TIMEOUT) == 201
    import ray_tpu
    ray_tpu.init(num_cpus=2)
    try:
        assert ray_tpu.get(ray_tpu.remote(outer_jax).remote(),
                           timeout=TIMEOUT) == 201
    finally:
        ray_tpu.shutdown()


def test_nested_task_on_one_cpu_node():
    """The outer task holds the node's only CPU; blocked in ``get`` it
    gives it up, so the inner task runs (201) and the CPU comes back."""
    code = (
        "import ray_tpu_torch as rt\n"
        "from test_torch_sched import outer\n"
        "rt.init(num_cpus=1)\n"
        "print('got:', rt.get(rt.remote(outer).remote(), timeout=60))\n"
        "print('cpu:', rt.available_resources()['CPU'])\n"
        "rt.shutdown()\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(__file__), REPO]))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "got: 201" in out.stdout and "cpu: 1.0" in out.stdout
