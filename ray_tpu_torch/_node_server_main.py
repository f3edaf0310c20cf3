"""A node process (the port of ``ray_tpu/_private/node_server_main.py``):

    python -m ray_tpu_torch._node_server_main --address HOST:PORT \\
        --token TOKEN [--num-cpus N] [--num-tpus CARDS] \\
        [--resources JSON] [--advertise-host HOST]

joins the head at ``--address`` with the cluster token and serves tasks
and actors until the head tells it to stop, or its connection is gone for
longer than ``node_reconnect_grace_s``.  ``--num-tpus`` counts cards, as
``num_tpus`` does everywhere in the port.  The node must run on the
head's host: actors and the session's store listen on the loopback, so
the head refuses a node from another host (ROADMAP item 13 part 3 lifts
that).  ``_cluster.main``.
"""

from __future__ import annotations

import sys

from ._cluster import main

if __name__ == "__main__":
    sys.exit(main())
