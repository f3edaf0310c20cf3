"""Per-node proxies (counterpart of ray_tpu/serve/proxy.py): not ported.

JAX starts one proxy actor per cluster node, each serving the HTTP and
gRPC ingress.  The port has no node table to place them by, and the card's
machine has no ``grpcio``; the HTTP ingress runs in the process that calls
``serve.run(http_port=...)``.
"""

from __future__ import annotations

from .api import ITEM_6C


def start_node_proxies(*_args, **_kwargs):
    """One proxy actor per node (JAX: ``start_node_proxies``)."""
    raise NotImplementedError(f"per-node serve proxies are not ported yet: "
                              f"{ITEM_6C}; use serve.run(http_port=...)")


def stop_node_proxies(*_args, **_kwargs):
    """(JAX: ``stop_node_proxies``)."""
    raise NotImplementedError(f"per-node serve proxies are not ported yet: "
                              f"{ITEM_6C}")
