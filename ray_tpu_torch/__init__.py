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
``tune``: ``Tuner`` over tasks, its schedulers and searchers).

Importing this package (or ``ray_tpu_torch.data``) does not import torch:
a task worker imports it only where its function's module does.
"""

import os as _os

from ._actor import (ActorError, GetTimeoutError, ObjectRef,  # noqa: E402
                     ObjectRefGenerator, RayTpuError, TaskError, get,
                     get_actor, kill, put, remote, wait)
from ._tasks import (OutOfMemoryError, RemoteFunction,  # noqa: E402
                     RuntimeEnvSetupError, WorkerCrashedError, init,
                     is_initialized)
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
    every actor this process started (JAX: ``ray_tpu.shutdown``)."""
    from . import _actor, _tasks
    _tasks.shutdown()
    _actor.shutdown()


__all__ = ["init", "shutdown", "is_initialized", "remote", "get", "put",
           "wait", "kill", "get_actor", "ObjectRef", "ObjectRefGenerator",
           "RemoteFunction", "RayTpuError", "TaskError", "ActorError",
           "WorkerCrashedError", "OutOfMemoryError", "RuntimeEnvSetupError",
           "GetTimeoutError", "cluster_resources", "available_resources",
           "nodes", "placement_group", "remove_placement_group",
           "PlacementGroup", "PlacementGroupSchedulingStrategy",
           "NodeAffinitySchedulingStrategy"]
