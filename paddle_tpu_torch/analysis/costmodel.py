"""Static communication cost model for sharded programs.

Counterpart of paddle_tpu/analysis/costmodel.py.  Given the spec
assignment the sharding analyzer (`analysis.shard`) derives, this
module prices the collectives a training step implies — the gradient
all-reduce over dp, the partial-sum all-reduce when a product contracts
a sharded dim, reduce-scatter and all-gather under ZeRO-1, ppermute
hops for ring attention, implicit-reshard all-gathers at S003 conflict
points — in BYTES ON THE WIRE per step.

Wire bytes use the ring algorithm's costs (what NCCL's ring
collectives move):

    all-reduce       2 * (n-1)/n * payload
    all-gather       (n-1)/n * gathered payload
    reduce-scatter   (n-1)/n * payload
    all-to-all       (n-1)/n * payload
    ppermute         payload (one neighbor hop)

This is a RANKING model, not a simulator: overlap with compute, latency
terms and routing are out of scope.  Its job is to say which tensors
dominate the step's communication and how the total scales with the
mesh, before anything runs.  Totals land in the obs registry as
`shard_comm_bytes_total{collective}`.

The byte counts equal the JAX package's for the same program and mesh.
The one number that differs is the link rate behind
`step_seconds_floor`: the port's default is the card's own interconnect
(`DEFAULT_ICI_GBPS` below), and a caller passes `ici_gbps` for another.
The compute cost model is `fluid/analysis.py` (the roofline); this one
prices the wires between the cards.
"""

from collections import OrderedDict

__all__ = ["CommCostReport", "collective_wire_bytes",
           "DEFAULT_ICI_GBPS"]

# The rate at which one card pushes a ring's wire bytes to its
# neighbours, GB/s: an NVIDIA H100 SXM5's fourth-generation NVLink, 900
# GB/s over its 18 links counting both directions (NVIDIA's H100 data
# sheet), so 450 GB/s each way.  The card the port is measured on
# reports itself as "NVIDIA H100 80GB HBM3, 700.00 W" (nvidia-smi
# --query-gpu=name,power.limit --format=csv,noheader).  The name keeps
# the JAX module's spelling; override per call.
DEFAULT_ICI_GBPS = 450.0

COLLECTIVES = ("allreduce", "reducescatter", "allgather", "alltoall",
               "ppermute")


def collective_wire_bytes(collective, payload_bytes, n):
    """Ring-cost wire bytes for moving `payload_bytes` across `n`
    participants."""
    if n <= 1:
        return 0
    if collective == "allreduce":
        return int(2.0 * (n - 1) / n * payload_bytes)
    if collective in ("allgather", "reducescatter", "alltoall"):
        return int(1.0 * (n - 1) / n * payload_bytes)
    if collective == "ppermute":
        return int(payload_bytes)
    raise ValueError("unknown collective %r (one of %s)"
                     % (collective, ", ".join(COLLECTIVES)))


class CommEvent:
    """One collective a step implies."""

    __slots__ = ("collective", "axis", "n", "payload_bytes",
                 "wire_bytes", "detail")

    def __init__(self, collective, axis, n, payload_bytes, detail=""):
        self.collective = collective
        self.axis = axis
        self.n = int(n)
        self.payload_bytes = int(payload_bytes)
        self.wire_bytes = collective_wire_bytes(collective,
                                                payload_bytes, n)
        self.detail = detail

    def to_dict(self):
        return {"collective": self.collective, "axis": self.axis,
                "n": self.n, "payload_bytes": self.payload_bytes,
                "wire_bytes": self.wire_bytes, "detail": self.detail}

    def __repr__(self):
        return ("CommEvent(%s over %s[%d]: %d wire bytes, %s)"
                % (self.collective, self.axis, self.n, self.wire_bytes,
                   self.detail))


class CommCostReport:
    """Accumulates CommEvents and ranks them."""

    def __init__(self, ici_gbps=DEFAULT_ICI_GBPS):
        self.events = []
        self.ici_gbps = ici_gbps

    def add(self, collective, axis, n, payload_bytes, detail=""):
        if n <= 1 or payload_bytes <= 0:
            return None  # a 1-wide axis moves nothing
        ev = CommEvent(collective, axis, n, payload_bytes, detail)
        self.events.append(ev)
        return ev

    def totals(self):
        """{collective: wire bytes}, descending."""
        out = {}
        for ev in self.events:
            out[ev.collective] = out.get(ev.collective, 0) + ev.wire_bytes
        return OrderedDict(sorted(out.items(), key=lambda kv: -kv[1]))

    def total_wire_bytes(self):
        return sum(ev.wire_bytes for ev in self.events)

    def step_seconds_floor(self):
        """Serialized link time floor (no overlap assumed)."""
        return self.total_wire_bytes() / (self.ici_gbps * 1e9)

    def ranked(self, topk=None):
        evs = sorted(self.events, key=lambda e: -e.wire_bytes)
        return evs if topk is None else evs[:topk]

    def to_dict(self, topk=10):
        return {
            "totals": dict(self.totals()),
            "total_wire_bytes": self.total_wire_bytes(),
            "step_seconds_floor": self.step_seconds_floor(),
            "top": [ev.to_dict() for ev in self.ranked(topk)],
        }

    def format(self, topk=10):
        lines = ["comm cost (per step, ring-cost wire bytes):"]
        for coll, b in self.totals().items():
            lines.append("  %-14s %12d bytes" % (coll, b))
        for ev in self.ranked(topk):
            lines.append("    %-12s %s[%d] %10d B  %s"
                         % (ev.collective, ev.axis, ev.n,
                            ev.wire_bytes, ev.detail))
        return "\n".join(lines)

    def publish(self):
        """Count total wire bytes per collective into the obs registry
        (`shard_comm_bytes_total{collective}`)."""
        from ..obs import registry as registry_mod

        reg = registry_mod.get_registry()
        fam = reg.counter(
            "shard_comm_bytes_total",
            "static per-step wire bytes estimated by the sharding "
            "analyzer, by collective",
            labelnames=("collective",))
        for coll, b in self.totals().items():
            fam.labels(collective=coll).inc(b)
        return self
