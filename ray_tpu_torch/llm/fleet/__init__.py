"""ray_tpu_torch.llm.fleet: multi-replica decode serving (counterpart of
ray_tpu/llm/fleet).

N continuous-batching decode replicas behind the disagg admission router,
with prefix-cache-affinity routing (longest shared prompt prefix wins,
load-imbalance override), a shared prefill tier whose KV handoffs stay on
the card, and SLO-driven replica autoscaling over a windowed series store
(queue depth / shed rate / ITL p99).  On one card each replica and the
prefill tier run on their own CUDA streams and share one copy of the
weights.  ``RemoteReplica`` puts a replica in a process of its own
(a ``ReplicaHost`` actor), its handoffs crossing as CUDA IPC handles.
"""

from .autoscale import (FleetScaleDecision, ServeAutoscalePolicy,
                        ServeScaleConfig)
from .prefix import (DEFAULT_BLOCK, PrefixCache, full_hash, prefix_chain,
                     score_summary)
from .remote import RemoteReplica, ReplicaHost
from .replica import DecodeReplica
from .router import FleetRouter, RouteDecision, RoutingConfig
from .server import FLEET_KV_PREFIX, FleetConfig, FleetServer

__all__ = [
    "DEFAULT_BLOCK", "PrefixCache", "prefix_chain", "full_hash",
    "score_summary",
    "DecodeReplica", "RemoteReplica", "ReplicaHost",
    "FleetRouter", "RouteDecision", "RoutingConfig",
    "ServeAutoscalePolicy", "ServeScaleConfig", "FleetScaleDecision",
    "FleetConfig", "FleetServer", "FLEET_KV_PREFIX",
]
