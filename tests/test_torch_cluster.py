"""JAX's ``tests/test_cluster.py`` under both packages: the port's node
plane (``ray_tpu_torch.cluster_utils``: a head with no CPUs and three
2-CPU node processes joining it over TCP) against JAX's
``cluster_utils.Cluster``, case by case.

Each package runs all 15 cases in one fresh interpreter of its own
(``tests/_torch_cluster_fns.py``; the two run side by side), and each
case here holds the port's outcome equal to JAX's.  The cross-node case
also holds the port's data plane to the payload: the bytes the driver
pulled through it equal the object's size, so the value did not reach
the driver by mapping the node's segment by name.

Both clusters declare a node dead 2 s after its connection drops
(``RAY_TPU_NODE_RECONNECT_GRACE_S``; a killed node process on the head's
host is dead at once in the port), which keeps the failover cases short.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TIMEOUT_S = 400


def _env(pkg: str) -> dict:
    env = dict(os.environ)
    env.update(RTT_PKG=pkg, JAX_PLATFORMS="cpu",
               RAY_TPU_NODE_RECONNECT_GRACE_S="2",
               PYTHONPATH=os.pathsep.join([HERE, REPO]))
    env.pop("RAY_TPU_CONFIG_BLOB", None)
    return env


def _parse(pkg: str, out: str, err: str, rc) -> dict:
    for line in out.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[7:])
    raise AssertionError(f"the {pkg} scenario printed no result (rc "
                         f"{rc}):\n{out[-3000:]}\n{err[-5000:]}")


@pytest.fixture(scope="module")
def outcomes(tmp_path_factory):
    """{package: {case: {"value" | "error", "s"}}}: both packages' runs,
    started together."""
    procs = {}
    for pkg in ("jax", "port"):
        tmp = str(tmp_path_factory.mktemp(f"cluster_{pkg}"))
        procs[pkg] = subprocess.Popen(
            [sys.executable, "-m", "_torch_cluster_fns", tmp],
            env=_env(pkg), cwd=HERE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, start_new_session=True)
    out = {}
    for pkg, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            stdout, stderr = proc.communicate()
        out[pkg] = _parse(pkg, stdout, stderr, proc.returncode)
    return out


CASES = ["join_and_resources", "remote_dispatch_and_spread",
         "cross_node_object_transfer", "syncer_node_views",
         "worker_nested_get_of_remote_object", "worker_nested_submit",
         "actor_on_remote_node_ordering", "strict_spread_pg",
         "strict_pack_pg", "remote_workers_answer_stack_dump",
         "wedged_remote_worker_reported_unresponsive",
         "task_infeasible_until_node_joins",
         "actor_restarts_on_surviving_node",
         "object_reconstructed_after_node_death",
         "pg_bundle_rescheduled_after_node_death"]

#: What each case must give (JAX's assertions, as values).
EXPECTED = {
    "join_and_resources": [4, 6.0],
    "remote_dispatch_and_spread": True,
    "cross_node_object_transfer": {"last": 199999.0, "sum": True},
    "syncer_node_views": [True, True],
    "worker_nested_get_of_remote_object": 150000.0,
    "worker_nested_submit": 50,
    "actor_on_remote_node_ordering": list(range(20)),
    "strict_spread_pg": [True, 3, True, 3],
    "strict_pack_pg": [True, 1],
    "remote_workers_answer_stack_dump": [True, True, True, "ok"],
    "wedged_remote_worker_reported_unresponsive": [True, True, "ok"],
    "task_infeasible_until_node_joins": [True, "ok"],
    "actor_restarts_on_surviving_node": [1, 1, True],
    "object_reconstructed_after_node_death": [249999.0, 249999.0],
    "pg_bundle_rescheduled_after_node_death": [True, "CREATED", True],
}


def _value(outcomes, pkg, case):
    rec = outcomes[pkg].get(case)
    assert rec is not None, f"{pkg} did not run {case}"
    assert "error" not in rec, f"{pkg} {case}: {rec['error']}\n" \
        f"{rec.get('trace', '')}"
    return rec["value"]


@pytest.mark.parametrize("case", CASES)
def test_cluster_case_matches_jax(outcomes, case):
    jax_value = _value(outcomes, "jax", case)
    port_value = _value(outcomes, "port", case)
    if case == "cross_node_object_transfer":
        # The driver's read came through the port's data plane: the
        # bytes it pulled equal the object's payload.
        assert port_value.pop("pulled_equals_payload") is True
    assert jax_value == EXPECTED[case]
    assert port_value == jax_value
