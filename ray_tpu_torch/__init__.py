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
and the developer tools (``devtools``: the CUDA host-sync tripwire and the
RT5xx lint rules; ``profiler``: cluster captures with ``torch.profiler``
and the kernel-build/first-launch counts of ``recompile``).
"""

import os as _os

from ._actor import (ActorError, GetTimeoutError, ObjectRef,  # noqa: E402
                     ObjectRefGenerator, TaskError, get, kill, put, remote,
                     wait)

# Opt-in implicit host-sync tripwire (devtools/syncdebug.py): patches
# torch.Tensor's host coercions so every implicit sync of a CUDA tensor
# (float()/.item()/.tolist()/np.asarray()) is timed and attributed to its
# call site.
if _os.environ.get("RAY_TPU_SYNC_DEBUG") == "1":
    from .devtools import syncdebug as _syncdebug
    _syncdebug.install()

__all__ = ["remote", "get", "put", "wait", "kill", "ObjectRef",
           "ObjectRefGenerator", "TaskError", "ActorError",
           "GetTimeoutError"]
