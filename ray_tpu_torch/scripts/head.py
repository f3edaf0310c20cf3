"""The head as its own process (JAX: ``ray_tpu/scripts/head.py``):

    python -m ray_tpu_torch.scripts.head --node-port 0 --port -1 \
        --dashboard-port -1 --num-cpus 4 --num-tpus 1 --state-dir DIR

It runs ``init(head_port=, cluster_token=, state_dir=)`` and stays up
until SIGTERM or SIGINT, when it shuts the session down.  Drivers connect
with ``ray_tpu_torch.init(address=<node_address>, cluster_token=<token>)``;
both are in the address file (written mode 0600: the token is a secret),
with the head's pid.  Started again on the same ``--state-dir`` after a
crash, the head replays its tables: actors restart from their creation
specs, placement groups are planned again, the KV store is back.

The job server (``--port``) and the dashboard (``--dashboard-port``) are
ROADMAP Queue 1 item 14: both take only -1 (off), and the address file's
``address`` (the job server's) is null.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading

OPERATOR = 'ROADMAP Queue 1 item 14 ("the operator\'s surfaces")'


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m ray_tpu_torch.scripts.head")
    p.add_argument("--port", type=int, default=-1,
                   help="job server port: not ported yet, only -1 (off)")
    p.add_argument("--node-port", type=int, default=6380,
                   help="TCP port of the head's endpoint (0 = ephemeral)")
    p.add_argument("--token", default=None)
    p.add_argument("--num-cpus", type=float, default=None)
    p.add_argument("--num-tpus", type=int, default=None,
                   help="cards the head books (the card is the port's TPU)")
    p.add_argument("--address-file", default=None,
                   help="where to write the head's address, token and pid "
                        "(default: head_address in the state dir, or in "
                        "the working directory without one)")
    p.add_argument("--dashboard-port", type=int, default=-1,
                   help="dashboard port: not ported yet, only -1 (off)")
    p.add_argument("--state-dir", default="",
                   help="Durable controller-state dir (WAL + snapshot); a "
                        "restarted head replays it.  Empty: no "
                        "persistence.")
    args = p.parse_args(argv)
    for flag, value in (("--port", args.port),
                        ("--dashboard-port", args.dashboard_port)):
        if value != -1:
            raise NotImplementedError(
                f"{flag} {value}: the job server and the dashboard are not "
                f"ported yet (see {OPERATOR}); pass {flag} -1")

    import ray_tpu_torch
    token_str = args.token or os.urandom(16).hex()
    session = ray_tpu_torch.init(num_cpus=args.num_cpus,
                                 num_tpus=args.num_tpus,
                                 head_port=args.node_port,
                                 cluster_token=token_str.encode(),
                                 state_dir=args.state_dir or None)
    node_addr = "%s:%d" % session.head_server.address
    address_file = args.address_file or os.path.join(
        args.state_dir or os.getcwd(), "head_address")
    parent = os.path.dirname(address_file)
    if parent:
        os.makedirs(parent, exist_ok=True)
    # The token is a secret (the endpoint unpickles peer messages): the
    # file is 0600, also when it existed before.
    fd = os.open(address_file, os.O_WRONLY | os.O_CREAT | os.O_TRUNC,
                 0o600)
    os.fchmod(fd, 0o600)
    with os.fdopen(fd, "w") as f:
        json.dump({"address": None, "pid": os.getpid(),
                   "node_address": node_addr, "token": token_str,
                   "session_id": session.id}, f)

    stop = threading.Event()

    def on_term(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGINT, on_term)
    print(f"ray_tpu_torch head listening on {node_addr}", flush=True)
    while not stop.wait(0.2):
        pass
    ray_tpu_torch.shutdown()
    try:
        os.unlink(address_file)
    except FileNotFoundError:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
