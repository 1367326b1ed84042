"""Distributed training: the parameter-server path.

Counterpart of paddle_tpu/distributed, its pserver half: a graph
transpiler that rewrites the trainer program to ship gradients to
native C++ pservers that run the optimizer server-side (reference:
python/paddle/v2/fluid/distribute_transpiler.py:81, operators/send_op.cc,
recv_op.cc, paddle/pserver/ParameterServer2, go/pserver/service.go), and
the elastic registry its pservers and trainers meet through, and the
dense collective path's entry points: `init_multihost` starts the job's
process group and `global_mesh` lays a mesh over it (parallel/).  The
fleet reporter (`start_fleet_reporter`, `stop_fleet_reporter`) pushes
this process's metric snapshots into the master's lease store
(obs/fleet.py).  `ranks.run_local_ranks` spawns gloo CPU ranks on this
machine for the CLIs' simulated fleets.
"""

from .transpiler import (DistributeTranspiler, split_dense_variable,
                         run_pserver)
from .coordinator import (init_multihost, global_mesh, process_count,
                          process_index, ElasticRegistry, ServiceLease,
                          discover_pservers, start_fleet_reporter,
                          stop_fleet_reporter)

__all__ = ["DistributeTranspiler", "split_dense_variable", "run_pserver",
           "init_multihost", "global_mesh", "process_count",
           "process_index", "ElasticRegistry", "ServiceLease",
           "discover_pservers", "start_fleet_reporter",
           "stop_fleet_reporter"]
