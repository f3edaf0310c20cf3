"""ray_tpu_torch.serve — model serving (counterpart of ``ray_tpu.serve``):
deployments whose replicas are process actors, a handle that routes each
request to the least-loaded replica, and ``run``/``status``/``shutdown``
(``api.py``).  Autoscaling, multiplexing and the HTTP/gRPC ingress raise
``NotImplementedError`` naming ROADMAP Queue 1 item 6b."""

from .api import (Application, Deployment, DeploymentHandle, OverloadError,
                  add_grpc_service, deployment, get_deployment_handle,
                  multiplexed, run, shutdown, status)

__all__ = [
    "deployment", "run", "shutdown", "status", "Deployment", "Application",
    "DeploymentHandle", "OverloadError", "get_deployment_handle",
    "multiplexed", "add_grpc_service",
]
