"""Fleet identity: the part of paddle_tpu/obs/fleet.py the SPMD trainer
stamps into the flight recorder's host context (`host_id`).

The rest of the JAX module — the per-host snapshot reporter that pushes
into the master's lease store, the aggregator and its straggler view,
`start_fleet_reporter` and the launcher's fleet view — comes with ROADMAP
A9's slice 22.
"""

import os
import socket

__all__ = ["host_id", "HOST_ENV"]

# the env var a launcher sets to name this worker
HOST_ENV = "PADDLE_FLEET_HOST"


def host_id():
    """Stable-ish identity for this worker: the launcher's
    PADDLE_FLEET_HOST, else rank (PADDLE_PROCESS_ID / TRAINER_ID),
    else hostname-pid."""
    explicit = os.environ.get(HOST_ENV)
    if explicit:
        return explicit
    for var in ("PADDLE_PROCESS_ID", "TRAINER_ID"):
        rank = os.environ.get(var)
        if rank is not None:
            return "host%s" % rank
    return "%s-%d" % (socket.gethostname(), os.getpid())
