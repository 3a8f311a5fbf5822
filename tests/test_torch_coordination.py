"""The port's coordination (memgraph_tpu_torch/coordination/) against the
JAX package's on the CPU, in process, over real TCP on ephemeral ports.

- Raft: a seeded 3-node cluster of the port elects one leader and commits
  on a majority, in log order on every node; a cluster of both packages'
  nodes does too (one wire); a node's election timeouts are its
  ``random.Random``'s draws, the reference's for the same seed.
- A scripted failover, run in each package: three coordinators, three
  data instances (``device="cpu"`` in the port), i1 MAIN; i1's
  management server stops, the coordinators promote i2 at fencing epoch
  2, i3 follows it, i1 learns its deposition from i3 (``MSG_FENCED``) and
  refuses writes with ``FencedException``; when i1's management server
  returns, the coordinators demote it and it catches up from i2.  Both
  packages end in the same topology, epochs, ``SHOW INSTANCES`` rows and
  Bolt ROUTE table (read over each package's own Bolt).
- A JAX coordinator drives a port data instance (promote, state check).
- The coordinator's federated exposition reads the port's metrics.

Tests wait on conditions under deadlines and assert outcomes, never
durations.
"""

import random
import socket
import time

import pytest
import torch

from memgraph_tpu.auth.auth import Auth as JAuth
from memgraph_tpu.coordination import coordinator as jcoord
from memgraph_tpu.coordination import data_instance as jdata
from memgraph_tpu.coordination import raft as jraft
from memgraph_tpu.query import interpreter as jinterp
from memgraph_tpu.server import bolt as jbolt
from memgraph_tpu.server import client as jclient
from memgraph_tpu.storage import InMemoryStorage as JStorage
from memgraph_tpu_torch.auth.auth import Auth as TAuth
from memgraph_tpu_torch.coordination import coordinator as tcoord
from memgraph_tpu_torch.coordination import data_instance as tdata
from memgraph_tpu_torch.coordination import raft as traft
from memgraph_tpu_torch.query import interpreter as tinterp
from memgraph_tpu_torch.server import bolt as tbolt
from memgraph_tpu_torch.server import client as tclient
from memgraph_tpu_torch.storage import InMemoryStorage as TStorage

from test_torch_bolt import serving

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

PKG = {
    "jax": dict(raft=jraft, coord=jcoord, data=jdata, interp=jinterp,
                storage=JStorage, bolt=jbolt, client=jclient, auth=JAuth),
    "torch": dict(raft=traft, coord=tcoord, data=tdata, interp=tinterp,
                  storage=TStorage, bolt=tbolt, client=tclient, auth=TAuth),
}
DEADLINE = 30.0


def ports(n):
    """n distinct free ephemeral ports (bound together, then released)."""
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    out = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return out


def wait_for(pred, timeout=DEADLINE):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return bool(pred())


def leader_of(nodes):
    leaders = [n for n in nodes if n.is_leader()]
    return leaders[0] if len(leaders) == 1 else None


def context(pkg):
    m = PKG[pkg]
    if pkg == "torch":
        return m["interp"].InterpreterContext(m["storage"](), device="cpu")
    return m["interp"].InterpreterContext(m["storage"]())


# --- Raft -----------------------------------------------------------------------

def raft_cluster(kinds, seed):
    """One node a package name in ``kinds``; each with its own seeded
    ``random.Random`` (the port) or election seed (the reference)."""
    ids = [f"c{i + 1}" for i in range(len(kinds))]
    ps = ports(len(ids))
    applied = {i: [] for i in ids}
    nodes = []
    for k, (nid, kind) in enumerate(zip(ids, kinds)):
        peers = {ids[j]: ("127.0.0.1", ps[j])
                 for j in range(len(ids)) if j != k}
        kw = {"rng": random.Random(seed + k)} if kind == "torch" \
            else {"election_seed": seed + k}
        nodes.append(PKG[kind]["raft"].RaftNode(
            nid, "127.0.0.1", ps[k], peers,
            apply_fn=lambda cmd, _n=nid: applied[_n].append(cmd), **kw))
    for n in nodes:
        n.start()
    return nodes, applied


@pytest.mark.parametrize("kinds", [("torch",) * 3, ("jax", "torch", "torch")],
                         ids=["port", "mixed"])
def test_raft_elects_one_leader_and_commits_on_a_majority(kinds):
    nodes, applied = raft_cluster(kinds, seed=101)
    try:
        assert wait_for(lambda: leader_of(nodes) is not None)
        leader = leader_of(nodes)
        for v in range(5):
            result = leader.propose({"op": "x", "v": v}, timeout=10)
            assert result and result.outcome == "committed"
        assert wait_for(lambda: all(
            [c["v"] for c in applied[n.node_id] if "v" in c]
            == list(range(5)) for n in nodes))
        # a majority without the leader elects a successor, which commits
        leader.stop()
        rest = [n for n in nodes if n is not leader]
        assert wait_for(lambda: leader_of(rest) is not None)
        assert leader_of(rest).propose({"op": "x", "v": 5}, timeout=10)
        assert wait_for(lambda: all(
            [c["v"] for c in applied[n.node_id] if "v" in c]
            == list(range(6)) for n in rest))
        follower = next(n for n in rest if not n.is_leader())
        refused = follower.propose({"op": "x", "v": 6})
        assert not refused and refused.outcome == "not_leader"
    finally:
        for n in nodes:
            n.stop()


def test_election_timeouts_are_the_seeded_rngs_draws():
    t = traft.RaftNode("c1", "127.0.0.1", 0, {}, rng=random.Random(7))
    j = jraft.RaftNode("c1", "127.0.0.1", 0, {}, election_seed=7)
    # the constructors drew one deadline each; the next draws agree
    assert [t._rng.uniform(*t.ELECTION_TIMEOUT) for _ in range(8)] == \
        [j._rng.uniform(*j.ELECTION_TIMEOUT) for _ in range(8)]
    a = traft.RaftNode("c2", "127.0.0.1", 0, {}, election_seed=3)
    b = traft.RaftNode("c2", "127.0.0.1", 0, {}, election_seed=3)
    assert [a._rng.random() for _ in range(4)] == \
        [b._rng.random() for _ in range(4)]


# --- failover ---------------------------------------------------------------------

class Data:
    """A data instance: a database, its management server, and the
    replication port the coordinators demote it onto."""

    def __init__(self, pkg, name, mgmt_port, repl_port):
        self.pkg, self.name = pkg, name
        self.ctx = context(pkg)
        self.interp = PKG[pkg]["interp"].Interpreter(self.ctx)
        self.mgmt_port, self.repl_port = mgmt_port, repl_port
        self.mgmt = None
        self.start_mgmt()

    def start_mgmt(self):
        self.mgmt = PKG[self.pkg]["data"].DataInstanceManagementServer(
            self.ctx, "127.0.0.1", self.mgmt_port, node_name=self.name)
        self.mgmt.start()

    @property
    def repl(self):
        return getattr(self.ctx, "replication", None)

    def count(self):
        return self.interp.execute("MATCH (n:HA) RETURN count(n)")[1][0][0]

    def stop(self):
        if self.mgmt is not None:
            self.mgmt.stop()
        if self.repl is not None:
            self.repl.shutdown()


def _write(data, v):
    try:
        data.interp.execute("CREATE (:HA {v: $v})", {"v": v})
        return "ok"
    except Exception as e:  # noqa: BLE001 — the outcome is the assertion
        return type(e).__name__


def failover_script(pkg):
    m = PKG[pkg]
    ps = ports(9)
    names = ["i1", "i2", "i3"]
    data = {n: Data(pkg, n, ps[3 + 2 * k], ps[4 + 2 * k])
            for k, n in enumerate(names)}
    coords = []
    for k in range(3):
        peers = {f"c{j + 1}": ("127.0.0.1", ps[j]) for j in range(3) if j != k}
        kw = {"rng": random.Random(500 + k)} if pkg == "torch" \
            else {"election_seed": 500 + k}
        c = m["coord"].CoordinatorInstance(f"c{k + 1}", "127.0.0.1", ps[k],
                                           peers, **kw)
        c.HEALTH_CHECK_INTERVAL = 0.2
        coords.append(c)
    out = {}
    try:
        for c in coords:
            c.start()
        assert wait_for(lambda: leader_of([c.raft for c in coords]))
        leader = next(c for c in coords if c.raft.is_leader())
        for k, n in enumerate(names):
            d = data[n]
            assert leader.register_instance(
                n, f"127.0.0.1:{d.mgmt_port}", f"127.0.0.1:{d.repl_port}",
                bolt_address=f"127.0.0.1:{17687 + k}")
        assert leader.set_instance_to_main("i1")
        i1, i2, i3 = (data[n] for n in names)
        assert wait_for(lambda: i1.repl is not None
                        and i1.repl.replica_names() == ["i2", "i3"])
        i1.repl.HEARTBEAT_INTERVAL_SEC = 0.1
        out["first_write"] = _write(i1, 1)
        out["replicated"] = [i2.count(), i3.count()]
        # the coordinators lose the MAIN's management server
        i1.mgmt.stop()
        assert wait_for(lambda: all(c.main_name == "i2" for c in coords))
        assert wait_for(lambda: i2.repl.role == "main"
                        and i3.repl.current_epoch() == 2)
        # i1 learns from i3, which answers at epoch 2 (MSG_FENCED)
        assert wait_for(i1.repl.is_fenced)
        out["deposed_write"] = _write(i1, 2)
        out["new_main_write"] = _write(i2, 3)
        out["after_failover"] = [i1.count(), i2.count(), i3.count()]
        out["epochs"] = [c.epoch for c in coords]
        out["fencing"] = [i1.repl.fencing_info(), i2.repl.fencing_info(),
                          i3.repl.fencing_info()]
        leader = next(c for c in coords if c.raft.is_leader())
        rows = leader.show_instances()
        # name, role, health (the address is this run's port)
        out["instances"] = [[r[0], r[2], r[3]] for r in rows
                            if r[0] in names]
        out["coordinator_rows"] = sorted(r[2] for r in rows
                                         if r[0] not in names)
        # ROUTE over this package's own Bolt, against a coordinator
        cctx = context(pkg)
        cctx.coordinator = coords[0]
        cctx.auth_store = m["auth"]()
        with serving(m["bolt"], cctx) as bolt_port:
            client = m["client"].BoltClient("127.0.0.1", bolt_port)
            try:
                out["route"] = client.route()
            finally:
                client.close()
        # i1's management server returns: demoted, then caught up from i2
        i1.start_mgmt()
        assert wait_for(lambda: i1.repl.role == "replica")
        assert wait_for(lambda: i1.count() == 2)
        assert wait_for(lambda: i2.repl.replica_names() == ["i1", "i3"])
        out["final"] = {n: data[n].repl.role for n in names}
        out["final_counts"] = [d.count() for d in data.values()]
        out["final_epochs"] = [c.epoch for c in coords]
        return out
    finally:
        for c in coords:
            c.stop()
        for d in data.values():
            d.stop()


@pytest.fixture(scope="module")
def failovers():
    return {pkg: failover_script(pkg) for pkg in ("jax", "torch")}


def test_a_scripted_failover_ends_as_in_the_reference(failovers):
    want, got = failovers["jax"], failovers["torch"]
    assert got == want
    assert got["first_write"] == "ok" and got["replicated"] == [1, 1]
    assert got["deposed_write"] == "FencedException"
    assert got["new_main_write"] == "ok"
    assert got["after_failover"] == [1, 2, 2]
    assert got["epochs"] == [2, 2, 2]
    assert got["fencing"] == [(2, True), (2, False), (2, False)]
    assert got["instances"] == [["i1", "replica", "down"],
                                ["i2", "main", "up"],
                                ["i3", "replica", "up"]]
    assert got["coordinator_rows"] == ["leader"]     # the leader's own row
    assert got["final"] == {"i1": "replica", "i2": "main", "i3": "replica"}
    assert got["final_counts"] == [2, 2, 2]
    assert got["final_epochs"] == [2, 2, 2]


def test_route_over_bolt_names_the_promoted_main(failovers):
    rt = failovers["torch"]["route"]
    assert rt == failovers["jax"]["route"]
    roles = {s["role"]: s["addresses"] for s in rt["servers"]}
    assert roles["WRITE"] == ["127.0.0.1:17688"]
    assert sorted(roles["READ"]) == ["127.0.0.1:17687", "127.0.0.1:17689"]
    assert rt["epoch"] == 2


def test_a_jax_coordinator_drives_a_port_data_instance():
    mgmt, repl, raft_port = ports(3)
    d = Data("torch", "i1", mgmt, repl)
    coord = jcoord.CoordinatorInstance("c1", "127.0.0.1", raft_port, {},
                                       election_seed=9)
    coord.start()
    try:
        assert wait_for(coord.raft.is_leader)
        assert coord.register_instance("i1", f"127.0.0.1:{mgmt}",
                                       f"127.0.0.1:{repl}")
        assert coord.set_instance_to_main("i1")
        assert wait_for(lambda: d.repl is not None and d.repl.role == "main")
        assert d.repl.current_epoch() == 1
        state = jdata.mgmt_call(f"127.0.0.1:{mgmt}", {"kind": "state_check"})
        assert state == {"ok": True, "role": "main", "fencing_epoch": 1,
                         "fenced": False, "replicas": [],
                         "last_commit_ts": d.ctx.storage.latest_commit_ts()}
        assert _write(d, 1) == "ok"
    finally:
        coord.stop()
        d.stop()


def test_the_federated_exposition_reads_the_ports_metrics():
    from memgraph_tpu_torch.utils.metrics import global_metrics
    mgmt, repl, raft_port = ports(3)
    d = Data("torch", "i1", mgmt, repl)
    coord = tcoord.CoordinatorInstance("c1", "127.0.0.1", raft_port, {},
                                       rng=random.Random(4))
    coord.start()
    try:
        assert wait_for(coord.raft.is_leader)
        assert coord.register_instance("i1", f"127.0.0.1:{mgmt}",
                                       f"127.0.0.1:{repl}")
        global_metrics.increment("test.federation_probe")
        reply = tdata.mgmt_call(f"127.0.0.1:{mgmt}", {"kind": "metrics"})
        assert reply["ok"] and "test_federation_probe" in reply["text"]
        text = coord.federated_prometheus_text()
        assert 'instance="i1"' in text and 'instance="c1"' in text
    finally:
        coord.stop()
        d.stop()
