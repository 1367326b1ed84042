"""Run a function on several gloo ranks of the port on the CPU.

`run_ranks(fn, world, tmp_path, *args)` spawns `world` processes (the
"spawn" start method), which meet at a `file://` store in `tmp_path`
(never a fixed TCP port, so parallel test workers never collide), each
with one torch thread, and calls `fn(rank, *args)` in every rank.  It
returns rank 0's result, passed back through a pickle in `tmp_path`.
`fn` must live in a module that imports only the port (the ranks never
import jax): the test files keep their rank-side cases in modules
whose imports are the port's.

`run_cases(cases, world, tmp_path)` runs many named cases in one spawn,
{name: fn(rank)}, and returns {name: result}, where a case that raised
gives its traceback as a string, so one failing case fails its own test
only.  The ranks stop after `timeout` seconds; a run cut so raises.
"""

import logging
import os
import pickle
import time
import traceback

import torch
import torch.multiprocessing as mp

__all__ = ["run_ranks", "run_cases", "CaseFailed"]


class CaseFailed(str):
    """The traceback of a rank-side case that raised."""


def _rank_main(rank, world, store, out, fn, args):
    torch.set_num_threads(1)
    # DTensor warns on every two-axis all-reduce it plans
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    import torch.distributed as dist

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


def run_ranks(fn, world, tmp_path, *args, timeout=240):
    store = os.path.join(str(tmp_path), "store")
    out = os.path.join(str(tmp_path), "result.pkl")
    ctx = mp.start_processes(_rank_main,
                             args=(world, store, out, fn, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError("ranks still running after %d s"
                                   % timeout)
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    with open(out, "rb") as f:
        return pickle.load(f)


def _cases_main(rank, cases):
    results = {}
    for name, (fn, args) in cases.items():
        try:
            results[name] = fn(rank, *args)
        except Exception:
            results[name] = CaseFailed(traceback.format_exc())
    return results


def run_cases(cases, world, tmp_path, timeout=240):
    """{name: (fn, args)} run in `world` ranks, one spawn for them all;
    {name: rank 0's result, or a CaseFailed traceback}."""
    return run_ranks(_cases_main, world, tmp_path, cases, timeout=timeout)
