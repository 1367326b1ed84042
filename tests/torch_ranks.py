"""Run a function on several gloo ranks of the port on the CPU.

`run_ranks(fn, world, tmp_path, *args)` is the port's
`distributed.ranks.run_local_ranks`: it spawns `world` processes (the
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

import traceback

from paddle_tpu_torch.distributed.ranks import run_local_ranks

__all__ = ["run_ranks", "run_cases", "CaseFailed"]


class CaseFailed(str):
    """The traceback of a rank-side case that raised."""


def run_ranks(fn, world, tmp_path, *args, timeout=240):
    return run_local_ranks(fn, world, tmp_path, *args, timeout=timeout)


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
