"""ray_tpu_torch — the PyTorch/CUDA port of ``ray_tpu`` for one NVIDIA H100.

The JAX package ``ray_tpu`` is the reference this package is held to: module
names mirror it (``ops/attention.py`` here ports ``ray_tpu/ops/attention.py``),
parameters keep its layout, and every kernel that ``ray_tpu`` wrote in Pallas
for the TPU is a CUDA C++ kernel written by hand for Hopper (``csrc/``).

This package imports ``torch`` and never ``jax`` or anything of ``ray_tpu``;
what it needs of the framework-free parts it keeps as its own copy.

Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``; with
no card visible and the CPU not asked for, they raise (``_device.py``).

Slices ported so far: serving (``llm``: engine, paged cache, model forward
passes; ``ops``: norms, rope, flash forward, paged decode; ``models.llama``),
training on one card (``parallel.spmd.make_lm_train_step`` over
``models.llama.loss_fn`` with remat, ``optim.adamw``, the flash backward),
and sharded training (``parallel``: mesh, sharding rules, the sharded step
over ``torch.distributed``; ``checkpoint``: the JAX package's wire format;
``train.mesh``: placement helpers and the mesh-reshape restore), and the
trainer (``train.TorchTrainer``: spawned workers over the ``_control``
plane, async sharded checkpoints with commit, failure restarts), the
serving tiers (``llm.disagg``, ``llm.fleet``) and reinforcement learning
(``rl``: PPO, DQN, SAC, TQC, IMPALA/APPO, offline, multi-agent, the
device-resident CartPole), and the process tier (``_actor``: spawned
process actors over the ``_control`` store; ``collective``: groups over
``torch.distributed``; RL's remote runners and DDP learners; ``serve``:
deployments whose replicas are actors, under ``build_llm_deployment`` and
``build_disagg_deployment``), compiled DAGs over those actors (``dag``),
the developer tools (``devtools``: the CUDA host-sync tripwire and the
RT5xx lint rules; ``profiler``: cluster captures with ``torch.profiler``
and the kernel-build/first-launch counts of ``recompile``), and tasks and
the data library (``init``/``remote`` on a function: a pool of spawned
workers with values in shared memory, ``_tasks``; ``data``: ``Dataset``
with its streaming executor over those tasks), and the scheduler tier
and tune (``_scheduler``: the host as one node of JAX's
``ClusterScheduler``, the card as ``GPU``, placement groups, nested
tasks, runtime envs, isolation, the OOM monitor; ``accelerators``,
``schedview``, ``util.gpu``; ``train``'s bookings and elastic resizes;
``tune``: ``Tuner`` over tasks, its schedulers and searchers), and the
developer tooling and one-host surfaces (``devtools``: every lint rule
family over the control-flow and lock analyses, the lock-order detector
and contention profiler; ``_sanitizer``: the leak sanitizer;
``util``: tracing across submits, user metrics, ``ActorPool``,
``Queue``), and the head (``_controller``: the tables, actors restarting
under ``max_restarts``; ``_persist``: the WAL behind
``init(state_dir=)``; ``_cluster``: the endpoint of
``init(head_port=...)``; ``_client``: ``init(address=...)``;
``scripts.head``: the head as its own process).

Importing this package (or ``ray_tpu_torch.data``) does not import torch:
a task worker imports it only where its function's module does.
"""

import os as _os

# Opt-in runtime lock-order detector (devtools/lockdebug.py).  Installed
# BEFORE the tiers' imports so the wrappers catch module-level framework
# locks too, not just ones created later.  Spawned workers and actors
# inherit the env var, so every process is instrumented alike.
if _os.environ.get("RAY_TPU_DEBUG_LOCKS") == "1":
    from .devtools import lockdebug as _lockdebug
    _lockdebug.install()

# Lighter opt-in lock-contention profiler (same module): per-site
# wait/hold histograms only, no order graph.  A no-op when the full
# debug mode above is active (its wrappers already collect them).
if _os.environ.get("RAY_TPU_LOCK_PROFILE") == "1":
    from .devtools import lockdebug as _lockdebug
    _lockdebug.install_profile()

# Opt-in runtime resource-leak sanitizer (_sanitizer.py): registries for
# framework threads / pins / tracked files / named actors, snapshotted at
# session start and diffed at shutdown().  Installed before the tiers'
# imports so module-level framework threads are attributed too.
if _os.environ.get("RAY_TPU_SANITIZE") == "1":
    from . import _sanitizer
    _sanitizer.install()

from .exceptions import (ActorError, GetTimeoutError,  # noqa: E402
                         ObjectLostError, OutOfMemoryError, RayTpuError,
                         RuntimeEnvSetupError, TaskError,
                         WorkerCrashedError)
from ._actor import (ActorClass, ActorHandle, ActorMethod,  # noqa: E402
                     ObjectRef, ObjectRefGenerator, get, get_actor, kill,
                     put, remote, wait)
from ._tasks import RemoteFunction, init, is_initialized  # noqa: E402
from ._scheduler import (NodeAffinitySchedulingStrategy,  # noqa: E402
                         PlacementGroup, PlacementGroupSchedulingStrategy,
                         available_resources, cluster_resources, nodes,
                         placement_group, remove_placement_group)

# Opt-in implicit host-sync tripwire (devtools/syncdebug.py): patches
# torch.Tensor's host coercions so every implicit sync of a CUDA tensor
# (float()/.item()/.tolist()/np.asarray()) is timed and attributed to its
# call site.
if _os.environ.get("RAY_TPU_SYNC_DEBUG") == "1":
    from .devtools import syncdebug as _syncdebug
    _syncdebug.install()


def shutdown() -> None:
    """End the task session (its workers and every segment of it) and kill
    every actor this process started (JAX: ``ray_tpu.shutdown``); in a
    client, disconnect from the head.

    Leak-sanitizer gate (``RAY_TPU_SANITIZE=1``): named actors are
    inspected before their processes are killed; threads, pins and file
    handles are diffed once both tiers are down, so a ``LeakError`` never
    leaves a half-shut session behind."""
    from . import _actor, _client, _sanitizer, _tasks
    _client.disconnect()
    active = _tasks._session is not None or _actor._session is not None
    pre = _sanitizer.pre_shutdown() if active else []
    _tasks.shutdown()
    _actor.shutdown()
    if active:
        _sanitizer.check_after_shutdown(pre)


__all__ = ["init", "shutdown", "is_initialized", "remote", "get", "put",
           "wait", "kill", "get_actor", "ObjectRef", "ObjectRefGenerator",
           "ActorHandle", "ActorClass", "ActorMethod", "RemoteFunction", "RayTpuError", "TaskError", "ActorError",
           "WorkerCrashedError", "OutOfMemoryError", "RuntimeEnvSetupError",
           "ObjectLostError",
           "GetTimeoutError", "cluster_resources", "available_resources",
           "nodes", "placement_group", "remove_placement_group",
           "PlacementGroup", "PlacementGroupSchedulingStrategy",
           "NodeAffinitySchedulingStrategy"]
