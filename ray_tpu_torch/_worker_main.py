"""A node's worker process (the port of ``ray_tpu/_private/worker_main.py``):

    python -m ray_tpu_torch._worker_main

Started by ``_node.NodeManager`` as a fresh interpreter with its socket,
ids and key in the environment (``RAY_TPU_NODE_SOCK``, ``RAY_TPU_AUTHKEY``,
``RAY_TPU_WORKER_ID``, ``RAY_TPU_NODE_ID``; ``RAY_TPU_SYS_PATH`` carries
the head's and the node's ``sys.path``, since functions cross by
reference); it dials back into the node's unix socket, registers, and
runs ``_worker.run_loop``.
"""

from __future__ import annotations

import sys


def main() -> None:
    from ._worker import node_worker_main
    node_worker_main()


if __name__ == "__main__":
    sys.exit(main())
