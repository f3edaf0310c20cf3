"""ray_tpu_torch.serve — model serving (counterpart of ``ray_tpu.serve``):
deployments whose replicas are process actors, a power-of-two-choices
router in every process that calls a handle, the serve controller
(replica recovery, autoscaling, versioned replica-set snapshots),
``@serve.batch``, model multiplexing, and the HTTP ingress
(``run(http_port=...)``).  The gRPC ingress and per-node proxies raise
``NotImplementedError`` naming ROADMAP Queue 1 item 6c."""

from .api import (Application, Deployment, DeploymentHandle, OverloadError,
                  add_grpc_service, deployment, get_deployment_handle,
                  remove_grpc_service, run, shutdown, status)
from .batching import batch
from .controller import AutoscalingConfig
from .long_poll import LongPollBroker
from .multiplex import get_multiplexed_model_id, multiplexed

__all__ = [
    "deployment", "run", "shutdown", "status", "Deployment", "Application",
    "DeploymentHandle", "OverloadError", "get_deployment_handle", "batch",
    "AutoscalingConfig", "LongPollBroker",
    "multiplexed", "get_multiplexed_model_id",
    "add_grpc_service", "remove_grpc_service",
]
