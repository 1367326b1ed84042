"""Run a function on several gloo ranks of this machine, on the CPU.

The JAX package's selftests simulate a fleet on one process's virtual
CPU devices (`--xla_force_host_platform_device_count`).  The port's
mesh lies over the ranks of a process group, so its CLIs' selftests
simulate one by spawning the ranks: `run_local_ranks(fn, world, workdir,
*args)` starts `world` processes ("spawn" start method, one torch thread
each), which meet at a `file://` store in `workdir` (no TCP port to
collide on), calls `fn(rank, *args)` in every rank and returns rank 0's
result.  `fn` must be importable by the spawned interpreters (a
module-level function).  A rank that raises fails the whole run with
its traceback, and ranks still running after `timeout` seconds are
terminated (killed when they outlive SIGTERM by 10 s), so a hung
collective cannot hang the caller.
"""

import logging
import os
import pickle
import time

__all__ = ["run_local_ranks"]


def _rank_main(rank, world, store, out, fn, args):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    # DTensor warns on every two-axis all-reduce it plans
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world)
    try:
        result = fn(rank, *args)
        if rank == 0:
            with open(out + ".tmp", "wb") as f:
                pickle.dump(result, f)
            os.replace(out + ".tmp", out)
    finally:
        dist.destroy_process_group()


def run_local_ranks(fn, world, workdir, *args, timeout=240):
    """`fn(rank, *args)` on `world` gloo ranks; rank 0's result."""
    import torch.multiprocessing as mp

    os.makedirs(str(workdir), exist_ok=True)
    store = os.path.join(str(workdir), "ranks_store_%d_%d"
                         % (os.getpid(), time.monotonic_ns()))
    out = store + ".result.pkl"
    ctx = mp.start_processes(_rank_main,
                             args=(world, store, out, fn, args),
                             nprocs=int(world), join=False,
                             start_method="spawn")
    deadline = time.monotonic() + float(timeout)
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError("%d ranks still running after %d s"
                                   % (world, timeout))
    finally:
        # SIGTERM first; a rank whose handler only notes it (a training
        # supervisor's) is killed after a grace period
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        for p in ctx.processes:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join(10)
    with open(out, "rb") as f:
        result = pickle.load(f)
    for path in (store, out):
        try:
            os.remove(path)
        except OSError:
            pass
    return result
