"""pelastic — elastic data-parallel training CLI + chaos drill.
Counterpart of paddle_tpu/tools/elastic_cli.py.

    # the certification run (its chaos workers on the card; --use_gpu=0
    # on the CPU):
    python -m paddle_tpu_torch.tools.elastic_cli --selftest

    # one elastic worker process (the multi-process drill spawns two):
    python -m paddle_tpu_torch.tools.elastic_cli worker \\
        --master 127.0.0.1:7164 --host w0 --ckpt-root /tmp/ck \\
        --status /tmp/w0.json --steps 40 [--use_gpu=0]

    # pin the densify-restore reassembly cost (8 shards -> 4 shards)
    # over the process group's ranks, or over gloo CPU ranks spawned
    # here when fewer are up:
    python -m paddle_tpu_torch.tools.elastic_cli densify-bench

`--selftest` certifies the elastic contract end to end, three phases:

  1. **protocol** — three in-process members bootstrap a view over a
     real native master; one member's heartbeat is killed, its lease
     expires, and the survivors commit a SHRINK at a higher
     generation (with an injected `elastic/propose` IOError retried
     along the way); the dead member rejoins and a GROW commits.
  2. **resize** — a simulated fleet of 2 hosts × 2 gloo CPU ranks
     (spawned here; the JAX selftest's 2 hosts × 4 virtual devices)
     trains an MLP with zero1 state on a dp=4 mesh in the global mode;
     losing a host REALLY rebuilds the mesh at dp=2 and restores the
     sharded snapshot through the densify path; the rejoin grows back
     to dp=4.  The densify-bench measurement (4 shards -> 2) runs on
     the same ranks.
  3. **chaos** — two real worker processes in the local mode (a mesh of
     one rank each, both on the card by default); a fault plan inside
     one delivers a real SIGTERM mid-step (`elastic/step:preempt`), the
     survivor commits a new generation and continues with finite
     losses, restoring shard-exact (`densified == []` — the layout
     held); a replacement worker (started beside the others, registering
     when the drill opens its start gate after the shrink) triggers the
     grow back.  The survivor's status file must show EXACTLY one shrink
     and one grow.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

from . import use_gpu_arg

GLOBAL_BATCH = 16
DIM = 8
CLASSES = 4
# seconds a gated worker waits for its start gate
GATE_TIMEOUT_S = 300.0


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="pelastic")
    p.add_argument("--selftest", action="store_true",
                   help="elastic certification: protocol drill + "
                        "simulated-fleet resize + 2-process chaos "
                        "drill")
    p.add_argument("--use_gpu", type=use_gpu_arg, default=True,
                   help="the selftest's chaos workers: 1 on the card "
                        "(the default), 0 on the CPU")
    sub = p.add_subparsers(dest="cmd")

    w = sub.add_parser("worker", help="run one elastic worker process")
    w.add_argument("--master", required=True,
                   help="host:port of the native master")
    w.add_argument("--host", required=True, help="this worker's host id")
    w.add_argument("--ckpt-root", required=True)
    w.add_argument("--status", default=None,
                   help="path for per-step status JSON")
    w.add_argument("--steps", type=int, default=40)
    w.add_argument("--global-batch", type=int, default=GLOBAL_BATCH)
    w.add_argument("--min-hosts", type=int, default=1)
    w.add_argument("--save-every", type=int, default=3)
    w.add_argument("--step-sleep", type=float, default=0.0)
    w.add_argument("--ttl-ms", type=int, default=500)
    w.add_argument("--hidden", type=int, default=64)
    w.add_argument("--seed", type=int, default=7,
                   help="fault-plan seed")
    w.add_argument("--faults", default=None,
                   help="comma list of point:kind[:after[:times]] "
                        "(e.g. elastic/step:preempt:5:1)")
    w.add_argument("--use_gpu", type=use_gpu_arg, default=True,
                   help="1 on the card (the default), 0 on the CPU")
    w.add_argument("--start-gate", default=None,
                   help="start up, write PATH.ready, and register only "
                        "once PATH exists (a replacement worker the "
                        "chaos drill starts beside the others)")

    b = sub.add_parser("densify-bench",
                       help="measure the 8-shard -> 4-shard densify "
                            "restore")
    b.add_argument("--from-dp", type=int, default=8)
    b.add_argument("--to-dp", type=int, default=4)
    b.add_argument("--vars", type=int, default=4)
    b.add_argument("--rows", type=int, default=1024)
    b.add_argument("--cols", type=int, default=256)

    return p.parse_args(argv)


def _builder(rows_fn, hidden):
    """build_fn for ElasticTrainer: an MLP classifier whose batch dim
    is re-derived from the committed view at every rebuild.  Same var
    names every call (reset_unique_name) so the rebuilt state dict
    lines up with the checkpointed one."""
    from .. import fluid

    def build():
        rows = rows_fn()
        fluid.framework.reset_unique_name()
        main = fluid.Program()
        startup = fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[rows, DIM],
                                  dtype="float32",
                                  append_batch_size=False)
            label = fluid.layers.data(name="label", shape=[rows, 1],
                                      dtype="int64",
                                      append_batch_size=False)
            h = fluid.layers.fc(input=x, size=hidden, act="relu")
            logits = fluid.layers.fc(input=h, size=CLASSES, act=None)
            loss = fluid.layers.softmax_with_cross_entropy(logits,
                                                           label)
            avg = fluid.layers.mean(loss)
            fluid.optimizer.MomentumOptimizer(
                learning_rate=0.1, momentum=0.9).minimize(avg)
        return main, startup, ["x", "label"], [avg.name]

    return build


def _make_feeds_fn(global_batch):
    import numpy as np

    def make_feeds(step, start, stop):
        # the FULL global batch is derived from the step alone, then
        # sliced — every member of any view feeds disjoint rows of the
        # same data, so a resize re-splits the same trajectory
        rs = np.random.RandomState(1000 + int(step))
        x = rs.rand(global_batch, DIM).astype(np.float32)
        label = rs.randint(0, CLASSES, size=(global_batch, 1)) \
            .astype(np.int64)
        return {"x": x[start:stop], "label": label[start:stop]}

    return make_feeds


def _wait_gate(gate, use_gpu):
    """A replacement worker's start: the trainer's imports and the card
    ready, `gate`.ready written, then `gate` awaited (GATE_TIMEOUT_S)."""
    import torch

    from ..spmd import trainer  # noqa: F401 — the import cost, paid now

    if use_gpu:
        torch.zeros(1, device="cuda")
    with open(gate + ".ready", "w"):
        pass
    deadline = time.time() + GATE_TIMEOUT_S
    while not os.path.exists(gate):
        if time.time() >= deadline:
            raise SystemExit("start gate %s never opened" % gate)
        time.sleep(0.05)


def run_worker(args):
    from ..resilience import faults
    from ..resilience.elastic import (ElasticMembership, feed_slice,
                                      run_elastic_worker)

    if args.faults:
        faults.enable(seed=args.seed)
        for item in args.faults.split(","):
            parts = item.strip().split(":")
            if len(parts) < 2:
                raise SystemExit("bad fault spec %r (want "
                                 "point:kind[:after[:times]])" % item)
            faults.inject(parts[0], parts[1],
                          after=int(parts[2]) if len(parts) > 2 else 0,
                          times=int(parts[3]) if len(parts) > 3 else 1)

    if args.start_gate:
        _wait_gate(args.start_gate, args.use_gpu)
    membership = ElasticMembership(args.master, host=args.host,
                                   ttl_ms=args.ttl_ms)

    def rows():
        start, stop = feed_slice(args.host, membership.view.hosts,
                                 args.global_batch)
        return stop - start

    try:
        summary = run_elastic_worker(
            membership, _builder(rows, args.hidden),
            _make_feeds_fn(args.global_batch), args.ckpt_root,
            steps=args.steps, global_batch=args.global_batch,
            min_hosts=args.min_hosts, save_every=args.save_every,
            status_path=args.status, step_sleep=args.step_sleep,
            local=True, device="cuda" if args.use_gpu else "cpu")
    finally:
        faults.disable()
        membership.close()
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    print("[pelastic] worker %s done: %s" % (args.host, json.dumps(
        {k: summary[k] for k in ("host", "steps", "generation",
                                 "preempted")})), flush=True)
    return 0


def _densify_ranks(rank, root, from_dp, to_dp, n_vars, rows, cols):
    from ..spmd.checkpoint import measure_densify_restore

    return measure_densify_restore(root, from_dp=from_dp, to_dp=to_dp,
                                   n_vars=n_vars, rows=rows, cols=cols)


def run_densify_bench(args):
    import torch.distributed as dist

    from ..distributed.ranks import run_local_ranks

    root = tempfile.mkdtemp(prefix="pelastic_densify_")
    need = max(args.from_dp, args.to_dp)
    bench = (root, args.from_dp, args.to_dp, args.vars, args.rows,
             args.cols)
    if dist.is_initialized() and dist.get_world_size() >= need:
        blob = _densify_ranks(dist.get_rank(), *bench)
    else:
        blob = run_local_ranks(_densify_ranks, need, root, *bench)
    print(json.dumps(blob, sort_keys=True), flush=True)
    return 0


# ---------------------------------------------------------------------------
# selftest
# ---------------------------------------------------------------------------

def _poll_converged(members, predicate, timeout=15.0, dead=()):
    """Drive every live member's protocol turn until `predicate(views)`
    holds (views keyed by host)."""
    deadline = time.time() + timeout
    while True:
        views = {}
        for m in members:
            if m in dead:
                continue
            try:
                views[m.host] = m.poll()
            except (IOError, OSError):
                views[m.host] = m.view  # injected fault: next turn
        if predicate(views):
            return views
        if time.time() >= deadline:
            raise AssertionError("protocol did not converge: %r"
                                 % views)
        time.sleep(0.03)


def _selftest_protocol():
    """Phase 1: bootstrap/shrink/grow of the bare membership protocol
    over a real master, with a lease ACTUALLY expiring (no
    survivor-side guesses) and an injected propose fault retried."""
    from .. import native
    from ..resilience import faults
    from ..resilience.elastic import ElasticMembership

    ttl = 300
    master = native.Master()
    members = []
    try:
        faults.enable(seed=3)
        # the FIRST propose attempt dies with an IOError; the leader's
        # next poll turn must retry and still converge
        propose_fault = faults.inject("elastic/propose", "io_error",
                                      times=1)
        for host in ("pa", "pb", "pc"):
            members.append(ElasticMembership(
                "127.0.0.1:%d" % master.port, host=host,
                ttl_ms=ttl).join())
        a, b, c = members

        _poll_converged(members, lambda vs: all(
            v.gen >= 1 and len(v.hosts) == 3 for v in vs.values()))
        assert propose_fault.fired == 1, \
            "elastic/propose fault never fired"
        gen0 = a.view.gen
        assert a.view.hosts == ["pa", "pb", "pc"]

        # pb stops heartbeating (NOT a graceful leave): only the TTL
        # reclaiming its lease may remove it from the live set
        b._member_lease._stop.set()
        b._member_lease._thread.join(timeout=5)
        _poll_converged(members, lambda vs: all(
            v.gen > gen0 and v.hosts == ["pa", "pc"]
            for h, v in vs.items() if h != "pb"), dead=(b,))
        assert a.view.reason == "host_lost", a.view
        gen1 = a.view.gen

        # pb rejoins (its orphaned lease must lapse first) -> grow
        b._member_lease = None
        b.join()
        _poll_converged(members, lambda vs: all(
            v.gen > gen1 and v.hosts == ["pa", "pb", "pc"]
            for v in vs.values()))
        assert a.view.reason == "rejoin", a.view
        assert a.view.gen > gen1 > gen0 >= 1
        return {"generations": [gen0, gen1, a.view.gen]}
    finally:
        faults.disable()
        for m in members:
            m.close()
        master.stop()


def _resize_until(et, save_step, membership=None, timeout=30.0,
                  what="resize"):
    """Elasticity turns (every rank in lockstep) until one commits.
    Rank 0 stops waiting at the deadline; the others learn it from the
    turn it broadcasts, so no rank waits past it.  A survivor whose own
    lease lapsed on a loaded host joins again, as a worker does."""
    import torch.distributed as dist

    deadline = time.time() + timeout
    while True:
        if et.membership is not None and not et.membership.alive:
            et.membership.join()
        if membership is not None:
            membership.poll()  # the rejoiner must ack the proposal
        got = et.maybe_resize(save_step=save_step)
        late = dist.get_rank() == 0 and time.time() >= deadline
        box = [bool(got is not None or late)]
        dist.broadcast_object_list(box, src=0)
        if got is not None:
            return got
        if box[0]:
            raise AssertionError("%s never committed" % what)
        time.sleep(0.03)


def _resize_leg(rank, workdir, hidden=1024):
    """Phase 2 in every rank of a group of 4 (2 hosts x 2 ranks): a REAL
    mesh shrink dp=4 -> dp=2 with zero1 state restored through the
    densify path, then the grow back; the densify-bench on the same
    ranks.  Rank 0 runs the master and both hosts' memberships (the
    simulated fleet) and polls for all ranks.  Its leases outlive a
    loaded host's stall of a second (a lost host shrinks once its TTL
    runs out)."""
    import numpy as np

    from .. import native
    from ..resilience.elastic import ElasticMembership, ElasticTrainer
    from ..spmd.checkpoint import measure_densify_restore

    ttl = 1500
    master = h0 = h1 = None
    try:
        if rank == 0:
            master = native.Master()
            h0 = ElasticMembership("127.0.0.1:%d" % master.port,
                                   host="h0", ttl_ms=ttl).join()
            h1 = ElasticMembership("127.0.0.1:%d" % master.port,
                                   host="h1", ttl_ms=ttl).join()
            _poll_converged([h0, h1], lambda vs: all(
                v.gen >= 1 and len(v.hosts) == 2 for v in vs.values()))
        et = ElasticTrainer(
            h0, _builder(lambda: GLOBAL_BATCH, hidden),
            os.path.join(workdir, "resize_ckpts"),
            devices_per_host=2, zero_stage=1, device="cpu")
        boot = et.maybe_resize()
        assert boot["direction"] == "bootstrap" and et.dp == 4, boot
        assert et.trainer.elastic_generation == et.generation

        def train(n):
            # one FIXED batch throughout (step 0's): across two mesh
            # rebuilds + restores the loss on it decreases iff the
            # optimizer state genuinely carried over each resize
            out = []
            for _ in range(n):
                feeds = _make_feeds_fn(GLOBAL_BATCH)(0, 0, GLOBAL_BATCH)
                fetches = et.step(feeds)
                out.append(None if fetches is None else float(
                    fetches[0].reshape(-1)[0]))
            return out

        losses = train(4)
        et.save(4)

        # h1 dies (heartbeat stops, lease expires) -> shrink to dp=2
        if rank == 0:
            h1._member_lease._stop.set()
            h1._member_lease._thread.join(timeout=5)
        shrink = _resize_until(et, 4, what="shrink")
        assert shrink["direction"] == "shrink" \
            and shrink["reason"] == "host_lost", shrink
        assert et.dp == 2, et.dp
        assert et.in_mesh == (rank < 2), (rank, et.in_mesh)
        if rank < 2:
            assert shrink["densified"], \
                "dp 4->2 with zero1 state should have densified " \
                "something: %r" % shrink
        losses += train(4)
        et.save(8)

        # h1 rejoins -> grow back to dp=4 (densified again: 2->4)
        if rank == 0:
            h1._member_lease = None
            h1.join()
        grow = _resize_until(et, 8, membership=h1, what="grow")
        assert grow["direction"] == "grow" \
            and grow["reason"] == "rejoin", grow
        assert et.dp == 4 and et.in_mesh, et.dp
        losses += train(4)
        if rank == 0:
            assert all(np.isfinite(l) for l in losses), losses
            assert losses[-1] < losses[0], losses
        else:
            assert all(l is None for l in losses[4:8]) == (rank >= 2)
        bench = measure_densify_restore(
            os.path.join(workdir, "densify_bench"), from_dp=4, to_dp=2)
        from ..obs import telemetry as obs_tele

        return {"losses": losses, "shrink": shrink, "grow": grow,
                "bench": bench, "registry": obs_tele.snapshot()}
    finally:
        for m in (h0, h1):
            if m is not None:
                m.close()
        if master is not None:
            master.stop()


def _read_status(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (IOError, OSError, ValueError):
        return None


def _stopped(stop):
    return stop is not None and stop.is_set()


def _wait_status(path, predicate, timeout, what, stop=None):
    deadline = time.time() + timeout
    while time.time() < deadline and not _stopped(stop):
        st = _read_status(path)
        if st is not None and predicate(st):
            return st
        time.sleep(0.05)
    raise AssertionError("timed out waiting for %s (last status: %r)"
                         % (what, _read_status(path)))


def _wait_exit(proc, timeout, stop=None):
    """`proc`'s exit code; None when it still runs after `timeout` s or
    once `stop` is set."""
    deadline = time.time() + timeout
    while time.time() < deadline and not _stopped(stop):
        if proc.poll() is not None:
            return proc.returncode
        time.sleep(0.05)
    return None


def _spawn_worker(master_port, host, workdir, steps, use_gpu,
                  faults=None, tag=None, gate=None):
    """A worker process for `host`; its status and log files are named
    by `tag` (default the host)."""
    tag = tag or host
    status = os.path.join(workdir, "%s.status.json" % tag)
    cmd = [sys.executable, "-m", "paddle_tpu_torch.tools.elastic_cli",
           "worker", "--master", "127.0.0.1:%d" % master_port,
           "--host", host, "--ckpt-root",
           os.path.join(workdir, "ckpts"), "--status", status,
           "--steps", str(steps), "--min-hosts", "2",
           "--ttl-ms", "2000", "--step-sleep", "0.08",
           "--save-every", "3", "--use_gpu=%d" % bool(use_gpu)]
    if faults:
        cmd += ["--faults", faults]
    if gate:
        cmd += ["--start-gate", gate]
    env = dict(os.environ)
    # the workers import this checkout's package
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env["PADDLE_FLEET_HOST"] = host
    log = open(os.path.join(workdir, "%s.log" % tag), "a")
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                            env=env)
    proc._log = log
    return proc, status


def _selftest_chaos(workdir, use_gpu=True, steps=60, stop=None):
    """Phase 3: two real worker processes; a fault plan inside w1
    delivers a real SIGTERM mid-step; the survivor shrinks and
    continues shard-exact; a replacement w1 grows the fleet back.  The
    replacement process starts beside the first two and registers when
    the drill opens its start gate, after the shrink: the survivor's
    remaining steps never race a process start.  Setting the event
    `stop` (from another thread) ends every wait at once: the drill
    fails and its workers are killed."""
    from .. import native

    master = native.Master()
    procs = []
    gate = os.path.join(workdir, "w1b.gate")
    try:
        w0, st0 = _spawn_worker(master.port, "w0", workdir, steps,
                                use_gpu)
        procs.append(w0)
        # w1's own fault plan raises a REAL SIGTERM at its 6th step
        w1, st1 = _spawn_worker(master.port, "w1", workdir, steps,
                                use_gpu,
                                faults="elastic/step:preempt:5:1")
        procs.append(w1)
        w1b, st1b = _spawn_worker(master.port, "w1", workdir, steps,
                                  use_gpu, tag="w1b", gate=gate)
        procs.append(w1b)

        # both bound to the 2-host view and stepping
        _wait_status(st0, lambda s: s["generation"] >= 1
                     and s["n_hosts"] == 2 and s["step"] >= 2,
                     120, "w0 to start on the 2-host view", stop)
        _wait_status(st1, lambda s: s["generation"] >= 1
                     and s["n_hosts"] == 2 and s["step"] >= 2,
                     120, "w1 to start on the 2-host view", stop)

        # the injected SIGTERM fires; w1 exits preempted, gracefully
        assert _wait_exit(w1, 60, stop) == 0, "preempted worker exit code"
        final1 = _wait_status(st1, lambda s: s.get("preempted"),
                              10, "w1's preempted status", stop)

        # the survivor commits the shrink and keeps stepping at dp-1
        shrunk = _wait_status(
            st0, lambda s: s["n_hosts"] == 1 and any(
                r["direction"] == "shrink" for r in s["resizes"]),
            60, "w0 to commit the shrink", stop)
        step_at_shrink = shrunk["step"]
        _wait_status(st0, lambda s: s["step"] > step_at_shrink + 1,
                     60, "w0 to keep training after the shrink", stop)

        # the replacement registers under the same host id -> grow back
        deadline = time.time() + 120
        while not os.path.exists(gate + ".ready"):
            assert w1b.poll() is None and time.time() < deadline \
                and not _stopped(stop), \
                "the replacement worker never reached its start gate"
            time.sleep(0.05)
        with open(gate, "w"):
            pass
        _wait_status(
            st0, lambda s: s["n_hosts"] == 2 and any(
                r["direction"] == "grow" for r in s["resizes"]),
            120, "w0 to commit the grow", stop)

        assert _wait_exit(w0, 180, stop) == 0, "w0 exit code"
        assert _wait_exit(w1b, 180, stop) == 0, \
            "replacement w1 exit code"
        final0 = _read_status(st0)

        # the acceptance criterion: exactly one shrink and one grow in
        # the survivor's committed history, shard-exact restores
        # (the per-host layout held -> nothing densified), training
        # completed with finite losses at a bumped generation
        directions = [r["direction"] for r in final0["resizes"]]
        assert directions.count("shrink") == 1 \
            and directions.count("grow") == 1, directions
        for r in final0["resizes"]:
            assert r["densified"] == [], \
                "chaos-drill restore densified %r (layout held — " \
                "must be shard-exact)" % r
        assert final0["done"] and final0["step"] == steps, final0
        assert final0["generation"] >= 3, final0
        for st in (final0, final1):
            assert all(l is not None and l == l
                       for l in st["losses"]), st
        return {"w0": final0, "w1_preempted_at": final1["step"],
                "resizes": final0["resizes"]}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            p._log.close()
        master.stop()


def selftest(use_gpu=True):
    from ..distributed.ranks import run_local_ranks

    workdir = tempfile.mkdtemp(prefix="pelastic_")

    proto = _selftest_protocol()
    print("[pelastic] phase 1 (protocol) green: generations %s "
          "(bootstrap -> lease-expiry shrink -> rejoin grow)"
          % proto["generations"], flush=True)

    resize = run_local_ranks(_resize_leg, 4, workdir, workdir)
    print("[pelastic] phase 2 (resize) green: 2 hosts x 2 gloo ranks, "
          "dp 4->2->4, shrink densified %d var(s), grow densified %d, "
          "loss %.4f -> %.4f"
          % (len(resize["shrink"]["densified"]),
             len(resize["grow"]["densified"]),
             resize["losses"][0], resize["losses"][-1]), flush=True)
    bench = resize["bench"]
    assert bench["verified"] and bench["densified"] == bench["n_vars"]
    print("[pelastic] densify-bench: %s"
          % json.dumps(bench, sort_keys=True), flush=True)

    chaos = _selftest_chaos(workdir, use_gpu=use_gpu)
    print("[pelastic] phase 3 (chaos) green: w1 SIGTERM'd at step %d "
          "by its fault plan, survivor resized %s and finished %d "
          "steps at generation %d on the %s (workdir %s)"
          % (chaos["w1_preempted_at"],
             [(r["direction"], r["generation"])
              for r in chaos["resizes"]],
             chaos["w0"]["step"], chaos["w0"]["generation"],
             "card" if use_gpu else "CPU", workdir), flush=True)

    # the in-process registry saw both directions (phase 1), and so
    # did the resize leg's rank 0 (phase 2)
    from ..obs import telemetry as obs_tele

    for where, snap in (("this process", obs_tele.snapshot()),
                        ("the resize ranks", resize["registry"])):
        shrinks = sum(v for k, v in snap.items()
                      if k.startswith("elastic_resizes_total{")
                      and "direction=shrink" in k)
        grows = sum(v for k, v in snap.items()
                    if k.startswith("elastic_resizes_total{")
                    and "direction=grow" in k)
        assert shrinks >= 1 and grows >= 1, (where, snap)
        print("[pelastic] %s: elastic_resizes_total shrink=%d grow=%d, "
              "elastic_generation=%s"
              % (where, shrinks, grows, snap.get("elastic_generation")),
              flush=True)
    print("[pelastic] selftest green", flush=True)
    return 0


def main(argv=None):
    args = parse_args(argv)
    if args.cmd == "worker":
        os.environ.setdefault("PADDLE_FLEET_HOST", args.host)
        return run_worker(args)
    if args.cmd == "densify-bench":
        return run_densify_bench(args)
    if args.selftest:
        return selftest(use_gpu=args.use_gpu)
    parse_args(["--help"])
    return 2


if __name__ == "__main__":
    sys.exit(main())
