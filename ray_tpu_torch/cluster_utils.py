"""Nodes as processes on one host (the port of ``ray_tpu/cluster_utils.py``):
the head in this process (``init(num_cpus=head_num_cpus, head_port=0,
cluster_token=...)``) and each ``add_node`` a ``python -m
ray_tpu_torch._node_server_main`` process joining it over TCP, the real
join path.  Tests and ``chip_smoke.py`` use it to exercise registration,
remote dispatch, the data plane and node death as a cluster of hosts
would.

Each node runs in its own process group (``start_new_session``), so
``remove_node`` kills it together with its workers and actors
(``os.killpg``): the node-failure injection.  ``shutdown`` kills every
node left, then shuts the head's session down.

    from ray_tpu_torch.cluster_utils import Cluster
    c = Cluster(head_num_cpus=0)
    gpu = c.add_node(num_cpus=2, num_tpus=1)     # the card's node
    cpu = c.add_node(num_cpus=2)
    ...
    c.remove_node(gpu)                           # SIGKILL its group
    c.shutdown()

Functions cross by reference, so a node's workers import the driver's
modules: the head hands its ``sys.path`` to every node.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

__all__ = ["Cluster", "NodeHandle"]


def _kill_group(proc: subprocess.Popen) -> None:
    """SIGKILL a node process together with its workers and actors."""
    try:
        os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
    except (ProcessLookupError, PermissionError, OSError):
        try:
            proc.kill()
        except OSError:
            pass


@dataclass
class NodeHandle:
    proc: subprocess.Popen
    num_cpus: float
    resources: Optional[Dict[str, float]]
    #: The node's id (hex) once its join is seen.
    node_id: Optional[str] = None

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None


class Cluster:
    def __init__(self, initialize_head: bool = True,
                 head_num_cpus: float = 0,
                 head_resources: Optional[Dict[str, float]] = None,
                 token: Optional[bytes] = None,
                 head_num_tpus: Optional[int] = 0):
        import ray_tpu_torch
        self._token = token or os.urandom(8).hex().encode()
        self._nodes: List[NodeHandle] = []
        self.runtime = None
        self.session = None
        if initialize_head:
            self.session = ray_tpu_torch.init(
                num_cpus=head_num_cpus, num_tpus=head_num_tpus,
                resources=head_resources, head_port=0,
                cluster_token=self._token)
            self.runtime = self.session.runtime
        self.address = self.session.head_server.address

    @property
    def controller(self):
        return self.session.node.controller

    def add_node(self, num_cpus: float = 1, num_tpus: int = 0,
                 resources: Optional[Dict[str, float]] = None,
                 wait: bool = True, timeout: float = 60.0,
                 env: Optional[Dict[str, str]] = None) -> NodeHandle:
        """Start a node process with ``num_cpus`` CPUs, ``num_tpus`` cards
        and ``resources``; with ``wait``, return once it has joined."""
        host, port = self.address
        cmd = [sys.executable, "-m", "ray_tpu_torch._node_server_main",
               "--address", f"{host}:{port}",
               "--token", self._token.decode(),
               "--num-cpus", str(num_cpus),
               "--num-tpus", str(int(num_tpus))]
        if resources:
            cmd += ["--resources", json.dumps(resources)]
        child_env = dict(os.environ)
        child_env.update(env or {})
        before = self._alive_node_ids()
        # Its own process group: killing a node takes its workers along.
        proc = subprocess.Popen(cmd, env=child_env, start_new_session=True)
        handle = NodeHandle(proc, num_cpus, resources)
        self._nodes.append(handle)
        if wait:
            self.wait_for_nodes(timeout=timeout)
            new = self._alive_node_ids() - before
            if len(new) == 1:
                handle.node_id = next(iter(new))
        return handle

    def _alive_node_ids(self) -> set:
        return {n.node_id.hex() for n in self.controller.nodes.values()
                if n.alive and not n.is_head}

    def alive_node_count(self) -> int:
        return sum(1 for n in self.controller.nodes.values() if n.alive)

    def wait_for_nodes(self, count: Optional[int] = None,
                       timeout: float = 60.0) -> None:
        """Block until ``count`` nodes (default: the head and every live
        added node) are alive."""
        want = count if count is not None else 1 + len(
            [n for n in self._nodes if n.alive])
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.alive_node_count() >= want:
                return
            for n in self._nodes:
                if n.proc.poll() is not None and n.node_id is None:
                    raise RuntimeError(f"a node exited with code "
                                       f"{n.proc.returncode} before it "
                                       "joined")
            time.sleep(0.05)
        raise TimeoutError(f"cluster has {self.alive_node_count()} alive "
                           f"nodes, wanted {want}")

    def remove_node(self, handle: NodeHandle, wait_dead: bool = True,
                    timeout: float = 30.0) -> None:
        """SIGKILL a node's process group (the node-failure primitive);
        with ``wait_dead``, return once the head has seen it die."""
        if handle.proc.poll() is None:
            _kill_group(handle.proc)
            handle.proc.wait(timeout=10)
        if handle in self._nodes:
            self._nodes.remove(handle)
        if wait_dead:
            want = 1 + sum(1 for n in self._nodes if n.alive)
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                if self.alive_node_count() <= want:
                    return
                time.sleep(0.05)

    def node_pids(self) -> List[int]:
        """The pids of the live node processes."""
        return [h.proc.pid for h in self._nodes if h.alive]

    def shutdown(self) -> None:
        import ray_tpu_torch
        for h in list(self._nodes):
            if h.proc.poll() is None:
                _kill_group(h.proc)
        for h in list(self._nodes):
            try:
                h.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                h.proc.kill()
        self._nodes.clear()
        ray_tpu_torch.shutdown()

    def __enter__(self) -> "Cluster":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
