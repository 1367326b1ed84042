"""Cluster job launcher: spawn pservers + trainers for one training job.

Counterpart of paddle_tpu/tools/cluster_launch.py; its role processes
import paddle_tpu_torch.  reference: paddle/scripts/cluster_train/
paddle.py (fabric/ssh job spawner setting PADDLE_* env per process,
job_dispatch/job_pserver :33-104) and the env-var role protocol of
tests/book_distribute/notest_dist_fit_a_line.py:45-53
(TRAINING_ROLE / PSERVERS / TRAINER_ID).  Local mode runs everything on
this host; remote mode (--hosts) executes one pserver + N trainers per
host over ssh (override the transport with --ssh for bastions/tests).

Usage:
    python -m paddle_tpu_torch.tools.cluster_launch \
        --pservers=127.0.0.1:7164,127.0.0.1:7165 --trainers=2 \
        [--async] train.py [script args...]
    python -m paddle_tpu_torch.tools.cluster_launch \
        --hosts=host1,host2 --trainers-per-host=1 train.py ...

The role processes must find paddle_tpu_torch (install it, or pass its
checkout's root in PYTHONPATH through `env`).  A pserver that has not
reported ready within READY_TIMEOUT_S fails the launch.  An elastic job
exports PADDLE_OBS_MASTER (its master), so workers that call
`distributed.init_multihost` publish metric snapshots there, and the
launcher prints the aggregated per-host view after the trainers end
(`print_fleet_view`).
"""

import argparse
import os
import shlex
import signal
import subprocess
import sys
import threading

from .. import native

__all__ = ["launch", "launch_remote", "stop_remote",
           "print_fleet_view", "main", "READY_TIMEOUT_S"]

# seconds a pserver process has to bind its port (and, elastic, claim
# its slot) and say so
READY_TIMEOUT_S = 300.0


def _await_ready(procs, what):
    """Read each process's first stdout line, which must say "ready";
    raise when one says otherwise, ends, or is silent past
    READY_TIMEOUT_S (the reads run on daemon threads, so a silent
    process cannot block the launcher)."""
    lines = [None] * len(procs)

    def read(i, p):
        lines[i] = p.stdout.readline()

    readers = [threading.Thread(target=read, args=(i, p), daemon=True)
               for i, p in enumerate(procs)]
    for t in readers:
        t.start()
    for t in readers:
        t.join(timeout=READY_TIMEOUT_S)
    for line in lines:
        if line is None or "ready" not in line:
            raise RuntimeError("%s failed to start: %r" % (what, line))


def launch(script_argv, pservers, trainers, sync=True, env=None,
           python=sys.executable, elastic=False):
    """Spawn len(pservers) pserver processes + `trainers` trainer
    processes; returns (pserver_procs, trainer_procs[, master]).

    Returns (pserver_procs, trainer_procs, master); `master` is None
    unless elastic.

    elastic=True runs the reference's etcd-style flow instead of static
    endpoints: a master process carries the TTL-lease registry, each
    pserver binds a free port and registers its slot with heartbeats,
    trainers discover the live set via
    `distributed.discover_pservers()` (PADDLE_MASTER /
    PADDLE_PSERVER_COUNT env).  `pservers` then only sets the COUNT;
    the endpoints in it are ignored."""
    base_env = dict(os.environ)
    base_env.update(env or {})
    base_env["TRAINERS"] = str(trainers)
    base_env["PADDLE_SYNC"] = "1" if sync else "0"

    master = None
    if elastic:
        master = native.Master()
        base_env["PADDLE_MASTER"] = "127.0.0.1:%d" % master.port
        base_env["PADDLE_PSERVER_COUNT"] = str(len(pservers))
        # fleet observability rides the same master: workers that call
        # distributed.init_multihost (or start_fleet_reporter) publish
        # registry snapshots under /obs/<host>, and the launcher
        # prints the aggregated per-host view after the job
        base_env["PADDLE_OBS_MASTER"] = base_env["PADDLE_MASTER"]
        code = (
            "import os,signal;"
            "from paddle_tpu_torch import native;"
            "from paddle_tpu_torch.distributed import ElasticRegistry;"
            "s=native.ParameterServer(port=0,"
            "num_trainers=int(os.environ['TRAINERS']),"
            "sync=os.environ['PADDLE_SYNC']=='1');"
            "host,port=os.environ['PADDLE_MASTER'].rsplit(':',1);"
            "reg=ElasticRegistry(host,int(port));"
            "slot,lease=reg.register_pserver("
            "'127.0.0.1:%d'%s.port,"
            "int(os.environ['PADDLE_PSERVER_COUNT']));"
            "print('pserver ready slot',slot,flush=True);"
            "signal.pause()")
    else:
        base_env["PSERVERS"] = ",".join(pservers)
        code = _PSERVER_CODE

    ps_procs = []
    try:
        for ep in pservers:
            ps_procs.append(subprocess.Popen(
                [python, "-c", code],
                env={**base_env, "TRAINING_ROLE": "PSERVER",
                     "PSERVER_ENDPOINT": ep},
                stdout=subprocess.PIPE, text=True))
        # trainers have no connect retry: wait until every pserver has
        # bound its port (and, elastic, registered) before spawning them
        _await_ready(ps_procs, "pserver")
    except BaseException:
        for p in ps_procs:
            p.kill()
        if master is not None:
            master.stop()
        raise

    tr_procs = []
    for tid in range(trainers):
        tr_procs.append(subprocess.Popen(
            [python] + list(script_argv),
            env={**base_env, "TRAINING_ROLE": "TRAINER",
                 "TRAINER_ID": str(tid),
                 "PADDLE_FLEET_HOST": "trainer%d" % tid}))
    return ps_procs, tr_procs, master


def print_fleet_view(master, out=sys.stdout):
    """Aggregate whatever /obs/<host> snapshots the job's workers
    published into the master's lease store and print the host-labeled
    view + straggler report (obs.fleet).  Quietly a no-op when no
    worker reported."""
    from ..obs.fleet import FleetAggregator

    agg = FleetAggregator()
    try:
        n = agg.collect("127.0.0.1:%d" % master.port)
    except Exception as exc:  # noqa: BLE001 — an observability
        # printout must never turn a successful job into a failed
        # launcher exit (list_prefix buffer overflow, corrupt
        # snapshot, master already gone)
        out.write("[cluster] fleet view unavailable: %s\n" % exc)
        return None
    if not n:
        return None
    report = agg.stragglers()
    out.write(agg.render_text())
    out.write("[cluster] fleet: %d host snapshot(s), step_ms=%s, "
              "stragglers=%s\n"
              % (n, report["step_ms"], report["flagged"] or "none"))
    return report


def _pserver_code(wait):
    """`wait="signal"` parks on signal.pause() (local mode — SIGTERM
    reaches the process directly).  `wait="stdin"` parks on reading
    stdin (remote mode — without a pty, sshd does NOT forward signals
    to the remote command, but closing the ssh channel delivers EOF,
    so stdin-EOF is the reliable remote shutdown edge)."""
    park = ("signal.pause()" if wait == "signal"
            else "sys.stdin.read()")
    return (
        "import os,sys,signal;"
        "from paddle_tpu_torch.distributed import run_pserver;"
        "s=run_pserver(os.environ['PSERVER_ENDPOINT'],"
        "trainers=int(os.environ['TRAINERS']),"
        "sync=os.environ['PADDLE_SYNC']=='1');"
        "print('pserver ready', flush=True);"
        + park)


_PSERVER_CODE = _pserver_code("signal")


def _ssh_popen(ssh_cmd, host, workdir, role_env, argv, python,
               **popen_kwargs):
    """Execute `argv` on `host` through `ssh_cmd`.  The remote side runs
    one shell command string (ssh concatenates its trailing args with
    spaces), so every token is shell-quoted and the env rides inline —
    the reference launcher builds its remote commands the same way
    (cluster_train/paddle.py job_pserver/job_trainer)."""
    envs = " ".join("%s=%s" % (k, shlex.quote(str(v)))
                    for k, v in sorted(role_env.items()))
    cmd = "cd %s && env %s %s %s" % (
        shlex.quote(workdir), envs, shlex.quote(python),
        " ".join(shlex.quote(a) for a in argv))
    return subprocess.Popen(list(ssh_cmd) + [host, cmd], **popen_kwargs)


def launch_remote(script_argv, hosts, trainers_per_host=1, base_port=7164,
                  sync=True, env=None, python="python",
                  ssh_cmd=("ssh", "-o", "BatchMode=yes"), workdir=None,
                  port_step=0):
    """Run the job across `hosts` over ssh: one pserver per host (bound
    at base_port) plus trainers_per_host trainers per host with global
    TRAINER_IDs.  Returns (pserver_procs, trainer_procs) — the Popen
    handles of the ssh transports.  Shut pservers down with
    `stop_remote(proc)`: without a pty sshd does not forward signals
    to the remote command, so the remote side parks on reading stdin
    and exits on the EOF that closing the channel delivers.

    `ssh_cmd` is the transport argv prefix; tests substitute a local
    shim, bastion setups prepend ProxyJump options.  `port_step`
    staggers the per-host pserver ports (single-machine smoke runs
    where every "host" is a loopback alias)."""
    workdir = workdir or os.getcwd()
    pservers = ["%s:%d" % (h, base_port + i * port_step)
                for i, h in enumerate(hosts)]
    base_env = dict(env or {})
    base_env["TRAINERS"] = str(trainers_per_host * len(hosts))
    base_env["PADDLE_SYNC"] = "1" if sync else "0"
    base_env["PSERVERS"] = ",".join(pservers)

    ps_procs = []
    try:
        for host, ep in zip(hosts, pservers):
            ps_procs.append(_ssh_popen(
                ssh_cmd, host, workdir,
                {**base_env, "TRAINING_ROLE": "PSERVER",
                 "PSERVER_ENDPOINT": ep},
                ["-c", _pserver_code("stdin")], python,
                stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, text=True))
        _await_ready(ps_procs, "remote pserver")
    except BaseException:
        for p in ps_procs:
            p.kill()
        raise

    tr_procs = []
    tid = 0
    for host in hosts:
        for _ in range(trainers_per_host):
            tr_procs.append(_ssh_popen(
                ssh_cmd, host, workdir,
                {**base_env, "TRAINING_ROLE": "TRAINER",
                 "TRAINER_ID": str(tid)},
                list(script_argv), python))
            tid += 1
    return ps_procs, tr_procs


def stop_remote(proc, timeout=30):
    """Shut down a launch_remote pserver: EOF on the channel (the
    remote's stdin read returns), then terminate the local transport."""
    if proc.stdin is not None:
        try:
            proc.stdin.close()
        except OSError:
            pass
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.terminate()
        proc.wait(timeout=timeout)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pservers",
                    help="comma-separated host:port endpoints (local mode)")
    ap.add_argument("--trainers", type=int, default=1)
    ap.add_argument("--async", dest="sync", action="store_false",
                    help="async SGD (reference: asyncSGD)")
    ap.add_argument("--elastic", action="store_true",
                    help="etcd-style flow: master registry + pserver "
                         "slot registration + trainer discovery")
    ap.add_argument("--hosts",
                    help="comma-separated ssh hosts (remote mode: one "
                         "pserver per host + --trainers-per-host "
                         "trainers per host)")
    ap.add_argument("--trainers-per-host", type=int, default=1)
    ap.add_argument("--base-port", type=int, default=7164)
    ap.add_argument("--ssh", default="ssh -o BatchMode=yes",
                    help="transport command prefix for remote mode")
    ap.add_argument("--workdir", default=None,
                    help="remote working directory (default: cwd)")
    ap.add_argument("script", nargs=argparse.REMAINDER,
                    help="trainer script + args")
    args = ap.parse_args(argv)
    if not args.script:
        ap.error("missing trainer script")
    if bool(args.pservers) == bool(args.hosts):
        ap.error("exactly one of --pservers (local) or --hosts (remote)")
    if args.hosts and args.trainers != 1:
        ap.error("--hosts mode sizes trainers with --trainers-per-host")
    if args.hosts and args.elastic:
        ap.error("--elastic is a local-mode flow (remote elastic runs "
                 "the master on one host; launch it there locally)")

    master = None
    if args.hosts:
        ps_procs, tr_procs = launch_remote(
            args.script, args.hosts.split(","),
            trainers_per_host=args.trainers_per_host,
            base_port=args.base_port, sync=args.sync,
            ssh_cmd=tuple(shlex.split(args.ssh)), workdir=args.workdir)
    else:
        pservers = args.pservers.split(",")
        ps_procs, tr_procs, master = launch(
            args.script, pservers, args.trainers, sync=args.sync,
            elastic=args.elastic)
    rc = 0
    try:
        for p in tr_procs:
            rc |= p.wait()
        if master is not None:
            # before pservers stop: their /obs/ leases are still live
            print_fleet_view(master)
    finally:
        if args.hosts:
            for p in ps_procs:
                stop_remote(p)
        else:
            for p in ps_procs:
                p.send_signal(signal.SIGTERM)
            for p in ps_procs:
                p.wait()
        if master is not None:
            master.stop()
    return rc


if __name__ == "__main__":
    sys.exit(main())
