"""The port's elastic training (`paddle_tpu_torch.resilience.elastic`,
`tools/elastic_cli.py`) against the JAX package's, on the CPU.

- Generation-stamped manifests: the elastic identity in the manifest,
  a stale host refused naming both generations, the newest generation
  winning `latest_elastic_checkpoint` across hosts' roots, the same
  snapshot picked by both packages from one root written by both.
- The membership protocol over a real native master: bootstrap, a
  lease that truly expires (shrink, `host_lost`) and a rejoin (grow,
  `rejoin`) at rising generations; `ClusterView`'s single-line JSON
  equal to the JAX view's and read by it; a JAX member and a port
  member on one master agreeing on every committed view, since the keys
  and values are the JAX protocol's; no split brain under heartbeat
  latency and io_error faults (only a stopped heartbeat shrinks).
- `feed_slice` equal to the JAX function's; the supervisor's
  `elastic_resize` restart reason and generation (tests/test_elastic.py's
  case on the port's supervisor).
- The global mode at 4 gloo ranks as 2 hosts x 2 (`elastic_cli`'s resize
  leg, in one spawn through `torch_ranks`): dp 4 -> 2 -> 4 with ZeRO-1
  state densified on each resize, the ranks off the shrunk mesh taking
  no steps, the loss on one fixed batch falling across both resizes, the
  resize counters and the densify bench.
- `elastic_cli --selftest --use_gpu=0`: the protocol drill, the resize
  leg (its own spawn of 4 ranks) and the chaos drill with two worker
  processes (a real SIGTERM, exactly one shrink and one grow).
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from paddle_tpu import native as jnative
from paddle_tpu.resilience import elastic as jelastic
from paddle_tpu.spmd import checkpoint as jckpt

from paddle_tpu_torch import native
from paddle_tpu_torch.fluid import CPUPlace
from paddle_tpu_torch.parallel import make_mesh
from paddle_tpu_torch.parallel.sharding import NamedSharding, P
from paddle_tpu_torch.resilience import elastic, faults
from paddle_tpu_torch.spmd import checkpoint as tckpt
from paddle_tpu_torch.tools import elastic_cli

from torch_ranks import CaseFailed, run_cases

torch.set_num_threads(1)

TTL_MS = 300


def _poll_until(members, predicate, timeout=15.0, dead=()):
    deadline = time.time() + timeout
    while True:
        views = {}
        for m in members:
            if m in dead:
                continue
            try:
                views[m.host] = m.poll()
            except (IOError, OSError):
                views[m.host] = m.view
        if predicate(views):
            return views
        assert time.time() < deadline, \
            "protocol did not converge: %r" % views
        time.sleep(0.02)


@pytest.fixture(autouse=True)
def no_faults():
    yield
    faults.disable()


@pytest.fixture(scope="module")
def world_one():
    yield make_mesh(device="cpu")
    torch.distributed.destroy_process_group()


def test_names_equal_jax():
    assert sorted(elastic.__all__) == sorted(jelastic.__all__)
    for name in ("MEMBER_PREFIX", "VIEW_PREFIX", "ACK_PREFIX",
                 "COMMIT_PREFIX"):
        assert getattr(elastic, name) == getattr(jelastic, name)


# -- generation-stamped manifests -----------------------------------------

def test_manifest_records_elastic_identity(tmp_path):
    snap = tckpt.save_sharded(tmp_path, 7, {"w": np.arange(8.0)},
                              mesh_axes={"dp": 2}, generation=5,
                              plan_fingerprint="fp123")
    with open(os.path.join(snap, tckpt.SPMD_MANIFEST)) as f:
        man = json.load(f)
    assert (man["generation"], man["plan_fingerprint"], man["mesh"]) == \
        (5, "fp123", {"dp": 2})


def test_stale_host_refused_with_both_generations(world_one, tmp_path):
    snap = jckpt.save_sharded(tmp_path, 7, {"w": np.arange(8.0)},
                              generation=5)
    shardings = {"w": NamedSharding(world_one, P())}
    with pytest.raises(tckpt.StaleGenerationError) as err:
        tckpt.restore_sharded(snap, shardings, max_generation=4)
    assert err.value.manifest_generation == 5
    assert err.value.caller_generation == 4
    assert "generation 5" in str(err.value)
    assert "generation 4" in str(err.value)
    state, info = tckpt.restore_sharded(snap, shardings,
                                        max_generation=5)
    assert info["generation"] == 5
    np.testing.assert_array_equal(state["w"].full_tensor().numpy(),
                                  np.arange(8.0))


def test_latest_elastic_checkpoint_prefers_newest_generation(tmp_path):
    # host a saved step 9 at gen 1 (the JAX package); host b step 3 at
    # gen 2 (the port) — the POST-SHRINK snapshot wins at a lower step
    jckpt.save_sharded(tmp_path / "a", 9, {"w": np.ones(4)}, generation=1)
    tckpt.save_sharded(tmp_path / "b", 3, {"w": np.zeros(4)},
                       generation=2)
    snap = elastic.latest_elastic_checkpoint(tmp_path)
    assert snap is not None and os.sep + "b" + os.sep in snap
    assert snap == jelastic.latest_elastic_checkpoint(tmp_path)
    assert elastic.latest_elastic_checkpoint(tmp_path / "none") is None


# -- the membership protocol ------------------------------------------------

def _stop_heartbeat(member):
    member._member_lease._stop.set()
    member._member_lease._thread.join(timeout=5)


def test_bootstrap_shrink_grow_generations():
    master = native.Master()
    members = []
    try:
        for host in ("ma", "mb", "mc"):
            members.append(elastic.ElasticMembership(
                "127.0.0.1:%d" % master.port, host=host,
                ttl_ms=TTL_MS).join())
        a, b, c = members
        _poll_until(members, lambda vs: all(
            v.gen >= 1 and len(v.hosts) == 3 for v in vs.values()))
        gen0 = a.view.gen
        assert a.view.hosts == ["ma", "mb", "mc"]
        assert a.view == b.view == c.view

        # mb stops heartbeating: only true lease expiry removes it
        _stop_heartbeat(b)
        _poll_until(members, lambda vs: all(
            v.gen > gen0 and v.hosts == ["ma", "mc"]
            for h, v in vs.items() if h != "mb"), dead=(b,))
        gen1 = a.view.gen
        assert a.view.reason == "host_lost"

        # rejoin commits a grow at a still-higher generation
        b._member_lease = None
        b.join()
        _poll_until(members, lambda vs: all(
            v.gen > gen1 and v.hosts == ["ma", "mb", "mc"]
            for v in vs.values()))
        assert a.view.reason == "rejoin"
        assert a.view.gen > gen1 > gen0 >= 1
    finally:
        for m in members:
            m.close()
        master.stop()


def test_view_json_equal_jax_and_single_line():
    view = elastic.ClusterView(3, ["b", "a"], reason="host_lost",
                               proposer="a")
    blob = view.to_json()
    assert "\n" not in blob
    assert blob == jelastic.ClusterView(3, ["b", "a"], reason="host_lost",
                                        proposer="a").to_json()
    back = elastic.ClusterView.from_json(blob)
    assert back == view and back.hosts == ["a", "b"]
    assert back.reason == "host_lost" and back.proposer == "a"
    crossed = jelastic.ClusterView.from_json(blob)
    assert (crossed.gen, crossed.hosts, crossed.reason) == (3, ["a", "b"],
                                                            "host_lost")


def test_jax_and_port_members_share_one_protocol():
    """A JAX member and a port member over one master (the JAX
    package's native master) agree on every committed view."""
    master = jnative.Master()
    addr = "127.0.0.1:%d" % master.port
    j = t = None
    try:
        j = jelastic.ElasticMembership(addr, host="xa",
                                       ttl_ms=TTL_MS).join()
        t = elastic.ElasticMembership(addr, host="xb",
                                      ttl_ms=TTL_MS).join()
        _poll_until([j, t], lambda vs: all(
            v.gen >= 1 and v.hosts == ["xa", "xb"] for v in vs.values()))
        assert j.view.gen == t.view.gen
        gen0 = j.view.gen
        _stop_heartbeat(t)   # the port member's lease lapses
        _poll_until([j], lambda vs: vs["xa"].gen > gen0
                    and vs["xa"].hosts == ["xa"])
        assert j.view.reason == "host_lost"
        t._member_lease = None
        t.join()
        _poll_until([j, t], lambda vs: all(
            v.gen > gen0 + 0 and v.hosts == ["xa", "xb"]
            for v in vs.values()))
        assert t.view.gen == j.view.gen and t.view.reason == "rejoin"
    finally:
        for m in (j, t):
            if m is not None:
                m.close()
        master.stop()


def test_no_split_brain_under_heartbeat_turbulence():
    """Injected `coordinator/heartbeat` latency + io_error make both
    members' heartbeats slow and flaky — but their leases keep
    renewing, so the leader must NOT shrink a slow-but-alive host.  Only
    genuinely stopping the heartbeat (true lease expiry) may commit the
    shrink."""
    ttl = 600
    master = native.Master()
    a = b = None
    try:
        a = elastic.ElasticMembership("127.0.0.1:%d" % master.port,
                                      host="sa", ttl_ms=ttl).join()
        b = elastic.ElasticMembership("127.0.0.1:%d" % master.port,
                                      host="sb", ttl_ms=ttl).join()
        _poll_until([a, b], lambda vs: all(
            v.gen >= 1 and len(v.hosts) == 2 for v in vs.values()))
        gen0 = a.view.gen

        faults.enable(seed=11)
        lat = faults.inject("coordinator/heartbeat", "latency",
                            latency_s=ttl / 1000.0 / 3, times=6)
        ioe = faults.inject("coordinator/heartbeat", "io_error", times=2)
        deadline = time.time() + ttl / 1000.0 * 3
        while time.time() < deadline:
            view = a.poll()
            assert view.gen == gen0 and len(view.hosts) == 2, \
                "split-brain shrink: a slow-but-alive host was " \
                "declared dead (%r)" % view
            time.sleep(0.05)
        assert lat.fired >= 4 and ioe.fired >= 1, (lat, ioe)
        assert not b._member_lease.lapsed
        faults.disable()

        _stop_heartbeat(b)
        _poll_until([a], lambda vs: vs["sa"].gen > gen0
                    and vs["sa"].hosts == ["sa"])
        assert a.view.reason == "host_lost"
    finally:
        for m in (a, b):
            if m is not None:
                m.close()
        master.stop()


def test_wait_for_has_a_deadline():
    master = native.Master()
    m = None
    try:
        m = elastic.ElasticMembership("127.0.0.1:%d" % master.port,
                                      host="solo", ttl_ms=TTL_MS).join()
        t0 = time.time()
        with pytest.raises(TimeoutError, match="n_hosts=2"):
            m.wait_for(n_hosts=2, timeout=0.5)
        assert time.time() - t0 < 5
    finally:
        if m is not None:
            m.close()
        master.stop()


@pytest.mark.parametrize("hosts,batch", [
    (["w2", "w0", "w1"], 16), (["a"], 5), (["a", "b"], 3),
    (["h%d" % i for i in range(5)], 17)])
def test_feed_slice_equals_jax(hosts, batch):
    got = [elastic.feed_slice(h, hosts, batch) for h in sorted(hosts)]
    assert got == [jelastic.feed_slice(h, hosts, batch)
                   for h in sorted(hosts)]
    assert got[0][0] == 0 and got[-1][1] == batch
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))


# -- supervisor integration -------------------------------------------------

class _FakeSaver:
    """Minimal supervisor-saver protocol (dense side unused)."""

    interval_secs = 1e9

    def __init__(self, root):
        self.root = str(root)
        self._snaps = []
        self.restores = 0

    def save(self, step, scope=None):
        snap = os.path.join(self.root,
                            "snap_%05d_%02d" % (step, len(self._snaps)))
        os.makedirs(snap, exist_ok=True)
        self._snaps.append((step, snap))
        return snap

    def wait(self):
        pass

    def latest(self):
        return self._snaps[-1][1] if self._snaps else None

    def restore_latest(self, scope=None):
        self.restores += 1
        return self._snaps[-1][0] if self._snaps else None


def test_supervisor_elastic_resize_reason_and_generation(tmp_path):
    from paddle_tpu_torch.obs import registry as obs_registry
    from paddle_tpu_torch.obs import telemetry as obs_tele
    from paddle_tpu_torch.resilience.supervisor import (ElasticResized,
                                                        SUPERVISOR_META,
                                                        TrainingSupervisor)

    obs_registry.reset_registry()
    saver = _FakeSaver(tmp_path)
    sup = TrainingSupervisor(str(tmp_path), saver=saver,
                             steps_per_checkpoint=100, generation=1,
                             place=CPUPlace())
    fired = {"done": False}

    def step_fn(batch):
        if sup._step == 2 and not fired["done"]:
            fired["done"] = True
            raise ElasticResized(2, direction="shrink")
        return 1.0 / (sup._step + 1)

    summary = sup.run(step_fn, lambda: iter(range(5)), num_epochs=1)
    assert summary["steps"] == 5 and summary["restarts"] == 1
    assert saver.restores == 0
    assert sup.generation == 2
    snap = obs_tele.snapshot()
    assert snap.get("supervisor_restarts_total{reason=elastic_resize}"
                    ) == 1, snap
    assert "supervisor_restarts_total{reason=preempt}" not in snap
    with open(os.path.join(saver.latest(), SUPERVISOR_META)) as f:
        assert json.load(f)["generation"] == 2
    sup2 = TrainingSupervisor(str(tmp_path), saver=saver,
                              steps_per_checkpoint=100, place=CPUPlace())
    sup2._restore_latest()
    assert sup2.generation == 2


# -- the global mode at 4 ranks, and the CLI --------------------------------

def test_shrink_densifies_and_grow_restores_at_4_ranks(tmp_path):
    got = run_cases({"resize": (elastic_cli._resize_leg,
                                (str(tmp_path),))}, 4, tmp_path,
                    timeout=300)["resize"]
    if isinstance(got, CaseFailed):
        pytest.fail("rank-side resize leg raised:\n%s" % got)
    shrink, grow = got["shrink"], got["grow"]
    assert (shrink["direction"], shrink["reason"], shrink["dp"]) == \
        ("shrink", "host_lost", 2)
    assert (grow["direction"], grow["reason"], grow["dp"]) == \
        ("grow", "rejoin", 4)
    assert grow["generation"] > shrink["generation"] >= 2
    assert shrink["restored_step"] == 4 and grow["restored_step"] == 8
    velocities = sorted(n for n in shrink["densified"])
    assert velocities and all(n.endswith("_velocity_0")
                              for n in velocities)
    assert grow["densified"] == velocities
    losses = got["losses"]
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert losses[-1] < losses[4] < losses[0]
    snap = got["registry"]
    assert snap.get("elastic_resizes_total{direction=shrink,"
                    "reason=host_lost}", 0) >= 1, snap
    assert snap.get("elastic_resizes_total{direction=grow,"
                    "reason=rejoin}", 0) >= 1, snap
    assert snap.get("elastic_generation") == grow["generation"]
    assert snap.get("elastic_lost_hosts_total", 0) >= 1
    bench = got["bench"]
    assert bench["verified"] and bench["densified"] == bench["n_vars"]
    assert (bench["from_mesh"], bench["to_mesh"]) == ({"dp": 4},
                                                      {"dp": 2})


def test_elastic_cli_selftest_on_the_cpu(capsys):
    assert elastic_cli.main(["--selftest", "--use_gpu=0"]) == 0
    out = capsys.readouterr().out
    for phase in ("phase 1 (protocol) green", "phase 2 (resize) green",
                  "phase 3 (chaos) green", "selftest green"):
        assert phase in out, out
    assert "dp 4->2->4" in out and "on the CPU" in out
