"""The port's replication (memgraph_tpu_torch/replication/) against the JAX
package's on the CPU, over real TCP on ephemeral ports.

- Across packages, both ways: a MAIN of one package registers a replica
  of the other (catch-up by snapshot transfer), then SYNC commits; after
  each step both storages export equal ``export_csr`` arrays, equal
  counts, and the MAIN's ``SHOW REPLICAS`` row names the replica at the
  MAIN's last commit.
- A replica's ``CALL pagerank.get()`` (``device="cpu"``): one JAX MAIN
  feeds a JAX replica and a port replica; the port replica's cold CALL
  matches the JAX replica's (rtol 1e-5, atol 1e-9, as
  tests/test_torch_cypher_procedures.py), and after a replicated commit
  it takes a delta export, a warm start and (the MXU route forced on the
  CPU) a DeltaPlan and no plan build, within that file's warm bound (L1
  1e-4) of the JAX replica's.  The replica's bump carries the commit's
  changed gids.
- Frames apply on the replica's connection thread while CALLs loop on the
  replica: each answer is one committed version's; a CALL made while a
  frame is half applied answers the whole new version (the apply gate).
- A snapshot whose apply outlasts the connection's timeout registers in
  the port and times out in the reference (ROADMAP Queue 3 item 22).
- STRICT_SYNC degradation and ASYNC catch-up, the replica's write refusal
  and the fenced MAIN's ``FencedException``: the same outcomes, types
  and messages in both packages.
- Users and tenants reach a replica, also across packages, and survive
  its promotion.

Tests wait on conditions under deadlines and assert outcomes, never
durations.
"""

import threading
import time

import numpy as np
import pytest
import torch

from memgraph_tpu.auth.auth import Auth as JAuth
from memgraph_tpu.dbms.dbms import DbmsHandler as JDbms
from memgraph_tpu.ops import csr as jcsr
from memgraph_tpu.query import interpreter as jinterp
from memgraph_tpu.replication import main_role as jmain
from memgraph_tpu.storage import InMemoryStorage as JStorage
from memgraph_tpu_torch.auth.auth import Auth as TAuth
from memgraph_tpu_torch.dbms.dbms import DbmsHandler as TDbms
from memgraph_tpu_torch.ops import csr as tcsr
from memgraph_tpu_torch.ops.csr import GLOBAL_GRAPH_CACHE
from memgraph_tpu_torch.query import interpreter as tinterp
from memgraph_tpu_torch.replication import main_role as tmain
from memgraph_tpu_torch.storage import InMemoryStorage as TStorage
from memgraph_tpu_torch.storage.source import StorageSource as TSource
from memgraph_tpu_torch.utils.metrics import global_metrics

from test_torch_coordination import wait_for
from test_torch_snapshot import assert_same_snapshot

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

PKGS = {"jax": (jinterp, JStorage), "torch": (tinterp, TStorage)}
N, E = 400, 2400
CALL = "CALL pagerank.get() YIELD node, rank RETURN id(node), rank"


def context(pkg, storage=None):
    interp, storage_cls = PKGS[pkg]
    storage = storage if storage is not None else storage_cls()
    if pkg == "torch":
        return interp.InterpreterContext(storage, device="cpu")
    return interp.InterpreterContext(storage)


def build(interp, seed=3):
    """N users and E weighted follows, drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    interp.execute("UNWIND range(0, $n - 1) AS i CREATE (:U {id: i})",
                   {"n": N})
    interp.execute("CREATE INDEX ON :U(id)")
    pairs = np.stack([rng.integers(0, N, E),
                      (rng.random(E) ** 2 * N).astype(np.int64)], 1)
    weights = rng.uniform(0.5, 1.5, E)
    interp.execute("UNWIND $e AS p MATCH (a:U {id: p[0]}), (b:U {id: p[1]})"
                   " CREATE (a)-[:F {w: p[2]}]->(b)",
                   {"e": [[int(s), int(d), float(w)]
                          for (s, d), w in zip(pairs, weights)]})


def commit_edges(interp, seed, m=60):
    rng = np.random.default_rng(seed)
    pairs = np.stack([rng.integers(0, N, m), rng.integers(0, N, m)], 1)
    interp.execute("UNWIND $e AS p MATCH (a:U {id: p[0]}), (b:U {id: p[1]})"
                   " CREATE (a)-[:F {w: 1.0}]->(b)", {"e": pairs.tolist()})
    return pairs


#: SYNC commits after the catch-up: adds, property sets, deletes, vertices
SCRIPT = [
    lambda i: commit_edges(i, 11),
    lambda i: i.execute("MATCH (n:U) WHERE n.id % 17 = 0 SET n.score = n.id"),
    lambda i: i.execute("MATCH (a:U)-[e:F]->(b:U) WHERE a.id % 29 = 3 "
                        "DELETE e"),
    lambda i: i.execute("UNWIND range(0, 4) AS k CREATE (:V {k: k})"),
    lambda i: i.execute("MATCH (n:V {k: 2}) DETACH DELETE n"),
]


def export(pkg, storage):
    acc = storage.access()
    try:
        if pkg == "jax":
            return jcsr.export_csr(acc, to_device=False)
        return tcsr.export_csr(TSource(acc), to_device=False, device="cpu")
    finally:
        acc.commit()


def assert_same_state(mpkg, mctx, rpkg, rctx):
    graphs = {mpkg: export(mpkg, mctx.storage), rpkg: export(rpkg, rctx.storage)}
    assert_same_snapshot(graphs["jax"], graphs["torch"])
    mi, ri = PKGS[mpkg][0].Interpreter(mctx), PKGS[rpkg][0].Interpreter(rctx)
    for q in ("MATCH (n) RETURN count(n)", "MATCH ()-[e]->() RETURN count(e)",
              "MATCH (n:U) WHERE n.score IS NOT NULL RETURN sum(n.score)"):
        assert ri.execute(q)[1] == mi.execute(q)[1], q


class Pair:
    """A MAIN of package ``mpkg`` and a replica of ``rpkg`` on an
    ephemeral port; the MAIN holds the seeded graph."""

    def __init__(self, mpkg, rpkg, mode="SYNC", register=True):
        self.mpkg, self.rpkg = mpkg, rpkg
        self.mctx, self.rctx = context(mpkg), context(rpkg)
        self.main = PKGS[mpkg][0].Interpreter(self.mctx)
        self.rep = PKGS[rpkg][0].Interpreter(self.rctx)
        build(self.main)
        self.rep.execute("SET REPLICATION ROLE TO REPLICA WITH PORT 0")
        self.port = self.rctx.replication.replica_server.port
        if register:
            self.main.execute(f"REGISTER REPLICA r1 {mode} TO "
                              f"'127.0.0.1:{self.port}'")

    def close(self):
        for ctx in (self.mctx, self.rctx):
            if getattr(ctx, "replication", None) is not None:
                ctx.replication.shutdown()


@pytest.fixture(params=[("torch", "jax"), ("jax", "torch")],
                ids=["torch-main-feeds-jax", "jax-main-feeds-torch"])
def pair(request):
    p = Pair(*request.param)
    yield p
    p.close()


def test_catch_up_and_sync_commits_across_packages(pair):
    assert_same_state(pair.mpkg, pair.mctx, pair.rpkg, pair.rctx)
    for step in SCRIPT:
        step(pair.main)      # SYNC: the replica has it when this returns
        assert_same_state(pair.mpkg, pair.mctx, pair.rpkg, pair.rctx)
    rows = pair.main.execute("SHOW REPLICAS")[1]
    assert rows == [["r1", f"127.0.0.1:{pair.port}", "sync",
                     pair.mctx.storage.latest_commit_ts(), "ready"]]
    assert pair.rep.execute("SHOW REPLICATION ROLE")[1] == [["replica"]]


# --- a replica's CALL ----------------------------------------------------------

@pytest.fixture
def mxu_on_cpu(monkeypatch):
    """The MXU route (plan, placement, Benes gathers) on the CPU, with the
    plan builds and DeltaPlans counted."""
    from memgraph_tpu_torch.ops import pagerank as PR
    from memgraph_tpu_torch.ops import spmv_mxu
    monkeypatch.setenv("MEMGRAPH_TPU_FORCE_MXU", "1")
    monkeypatch.setattr(PR, "MXU_MIN_EDGES", 0)
    counts = {"build_plan": 0, "build_delta_plan": 0}
    for name in counts:
        real = getattr(spmv_mxu, name)

        def counted(*a, _real=real, _name=name, **k):
            counts[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(spmv_mxu, name, counted)
    return counts


def records(interp, query=CALL):
    rows = interp.execute(query)[1]
    out = {int(r[0]): float(r[1]) for r in rows}
    assert len(out) == len(rows)
    return out


def test_a_replica_call_after_a_replicated_commit_refreshes_by_delta(
        mxu_on_cpu):
    """One JAX MAIN, a JAX replica and a port replica (SYNC)."""
    mctx = context("jax")
    main = jinterp.Interpreter(mctx)
    build(main)
    reps = {}
    for i, pkg in enumerate(("jax", "torch")):
        ctx = context(pkg)
        PKGS[pkg][0].Interpreter(ctx).execute(
            "SET REPLICATION ROLE TO REPLICA WITH PORT 0")
        port = ctx.replication.replica_server.port
        main.execute(f"REGISTER REPLICA r{i} SYNC TO '127.0.0.1:{port}'")
        reps[pkg] = (ctx, PKGS[pkg][0].Interpreter(ctx))
    try:
        tctx, t = reps["torch"]
        j = reps["jax"][1]
        want, got = records(j), records(t)
        assert set(want) == set(got)
        np.testing.assert_allclose([got[g] for g in want],
                                   [want[g] for g in want],
                                   rtol=1e-5, atol=1e-9)
        assert mxu_on_cpu == {"build_plan": 1, "build_delta_plan": 0}
        storage = tctx.storage
        v0 = storage.topology_version
        delta0 = GLOBAL_GRAPH_CACHE.counters["export.delta"]
        warm0 = global_metrics.value("delta.warm_start_total")
        pairs = commit_edges(main, 41)
        # the frame's apply bumped the replica once, with the commit's gids
        gid_of = {r[0]: r[1] for r in t.execute(
            "MATCH (n:U) RETURN n.id, id(n)")[1]}
        assert storage.topology_version == v0 + 1
        assert storage.changes_between(v0, v0 + 1) == frozenset(
            gid_of[int(x)] for x in pairs.ravel())
        want, got = records(j), records(t)
        assert GLOBAL_GRAPH_CACHE.counters["export.delta"] == delta0 + 1
        assert global_metrics.value("delta.warm_start_total") == warm0 + 1
        assert mxu_on_cpu == {"build_plan": 1, "build_delta_plan": 1}
        assert set(want) == set(got)
        assert sum(abs(got[g] - want[g]) for g in want) < 1e-4
    finally:
        mctx.replication.shutdown()
        for ctx, _ in reps.values():
            ctx.replication.shutdown()


def _cold_ranks(batches):
    """gid-free ranks by user id of a fresh port database holding the
    seeded graph and the first ``batches`` commits."""
    ctx = context("torch")
    interp = tinterp.Interpreter(ctx)
    build(interp)
    for seed in range(100, 100 + batches):
        commit_edges(interp, seed, m=150)
    return ranks_by_id(interp)


def ranks_by_id(interp):
    out = np.zeros(N)
    for uid, rank in interp.execute(
            "CALL pagerank.get() YIELD node, rank "
            "RETURN node.id AS id, rank")[1]:
        out[uid] = rank
    return out


def test_frames_apply_while_calls_read():
    """A thread commits on a port MAIN (SYNC frames apply on the port
    replica's connection thread) while the replica answers CALLs: every
    answer is one committed version's (L1 under 1e-4 of that version's
    cold answer, and versions lie over 1e-3 apart)."""
    batches = 6
    refs = [_cold_ranks(b) for b in range(batches + 1)]
    for a in range(len(refs)):
        for b in range(a):
            assert np.abs(refs[a] - refs[b]).sum() > 1e-3
    p = Pair("torch", "torch")
    answers = []
    try:
        def writer():
            for seed in range(100, 100 + batches):
                commit_edges(p.main, seed, m=150)

        thread = threading.Thread(target=writer)
        thread.start()
        while thread.is_alive():
            answers.append(ranks_by_id(p.rep))
        thread.join()
        answers.append(ranks_by_id(p.rep))
    finally:
        p.close()
    for got in answers:
        l1 = [np.abs(got - ref).sum() for ref in refs]
        assert min(l1) < 1e-4, l1
    assert np.abs(answers[-1] - refs[-1]).sum() < 1e-4


def test_a_call_during_a_frame_apply_answers_one_version(monkeypatch):
    """Deterministic: the replica's apply of a 150-edge frame stops half
    way until a CALL has answered (2 s at most).  The CALL waits for the
    apply behind the storage's apply gate and answers the whole new
    version; read half way it would answer neither version."""
    from memgraph_tpu_torch.replication import replica as R
    refs = [_cold_ranks(b) for b in (0, 1)]
    p = Pair("torch", "torch")
    mid, answered = threading.Event(), threading.Event()
    real = R._apply_wal_txn

    def halting(storage, ops):
        ops = list(ops)
        changed = real(storage, ops[:len(ops) // 2])
        mid.set()
        answered.wait(2.0)
        return changed | real(storage, ops[len(ops) // 2:])

    try:
        ranks_by_id(p.rep)                  # the replica's base version
        monkeypatch.setattr(R, "_apply_wal_txn", halting)
        writer = threading.Thread(
            target=lambda: commit_edges(p.main, 100, m=150))
        writer.start()
        assert mid.wait(30)
        got = ranks_by_id(p.rep)
        answered.set()
        writer.join(30)
    finally:
        p.close()
    assert np.abs(got - refs[1]).sum() < 1e-4, \
        [np.abs(got - r).sum() for r in refs]


def test_a_snapshot_whose_apply_outlasts_the_connection_timeout(monkeypatch):
    """ROADMAP Queue 3 item 22: the reference waits for a snapshot's ack
    as long as for any reply (the connection's 30 s), so a replica whose
    load and apply take longer fails the registration; the port's
    deadline grows with the snapshot.  Scaled down: a 0.5 s connection
    timeout, an apply held 1.5 s."""
    import socket as _socket
    from memgraph_tpu.replication import replica as jrep
    from memgraph_tpu_torch.replication import replica as trep

    for mod in (jrep, trep):
        real = mod.ReplicaServer._apply_snapshot_bytes

        def slow(self, data, _real=real):
            time.sleep(1.5)
            return _real(self, data)

        monkeypatch.setattr(mod.ReplicaServer, "_apply_snapshot_bytes", slow)

    class ShortSocket:
        """The reference's socket module, its connections at 0.5 s."""

        def __getattr__(self, name):
            return getattr(_socket, name)

        @staticmethod
        def create_connection(address, timeout=None):
            return _socket.create_connection(address, timeout=0.5)

    monkeypatch.setattr(jmain, "socket", ShortSocket())
    monkeypatch.setattr(tmain.ReplicaClient, "CONNECT_TIMEOUT_SEC", 0.5)
    # the graph's snapshot (~60 KB) then waits 0.5 + 6 s
    monkeypatch.setattr(tmain.ReplicaClient, "SNAPSHOT_ACK_BYTES_PER_SEC",
                        10_000.0)
    outcomes = {}
    for pkg in ("jax", "torch"):
        p = Pair(pkg, pkg, register=False)
        try:
            outcomes[pkg] = _outcome(lambda: p.main.execute(
                f"REGISTER REPLICA r1 SYNC TO '127.0.0.1:{p.port}'"))
            if pkg == "torch":
                assert p.rep.execute("MATCH ()-[e]->() RETURN count(e)")[1] \
                    == [[E]]
        finally:
            p.close()
    assert outcomes["jax"] == ("QueryException: cannot register replica "
                               "'r1': timed out")
    assert outcomes["torch"] == "ok"


# --- modes, refusals, system transactions ---------------------------------------

def _outcome(fn):
    try:
        fn()
        return "ok"
    except Exception as e:  # noqa: BLE001 — the outcome is the assertion
        return f"{type(e).__name__}: {e}"


def _strict_script(pkg):
    """STRICT_SYNC: a commit, the replica lost (a failed vote, then
    unavailable), degradation to ASYNC once the retry budget is spent, and
    the ASYNC catch-up when the replica returns on its port."""
    p = Pair(pkg, pkg, register=False)
    mod = tmain if pkg == "torch" else jmain
    try:
        p.main.execute(f"REGISTER REPLICA r1 STRICT_SYNC TO "
                       f"'127.0.0.1:{p.port}'")
        state = p.mctx.replication
        state.HEARTBEAT_INTERVAL_SEC = 0.05
        client = state.replicas["r1"]
        client.retry_policy = type(client.retry_policy)(
            base_delay=0.01, max_delay=0.02, max_retries=2)
        out = [_outcome(lambda: commit_edges(p.main, 1, m=5))]
        out.append(p.rep.execute("MATCH ()-[e]->() RETURN count(e)")[1])
        p.rctx.replication.replica_server.stop()
        out.append(_outcome(lambda: commit_edges(p.main, 2, m=5)))
        out.append(_outcome(lambda: commit_edges(p.main, 3, m=5)))
        assert wait_for(client.retry_budget_exhausted)
        out.append(_outcome(lambda: commit_edges(p.main, 4, m=5)))
        out.append([r[2] for r in p.main.execute("SHOW REPLICAS")[1]])
        assert client.mode is mod.ReplicationMode.ASYNC
        # the replica returns on its port: the heartbeat reconnects it
        p.rctx.replication.set_role_replica("127.0.0.1", p.port)
        want = p.main.execute("MATCH ()-[e]->() RETURN count(e)")[1]
        assert wait_for(lambda: p.rep.execute(
            "MATCH ()-[e]->() RETURN count(e)")[1] == want)
        out.append(client.catchup_used)
        return out
    finally:
        p.close()


def test_strict_sync_degrades_and_async_catches_up_as_in_the_reference():
    want, got = _strict_script("jax"), _strict_script("torch")
    assert got == want
    assert got[0] == "ok" and got[2].startswith("TransactionException")
    assert got[3].startswith("ReplicaUnavailableException")
    assert got[4] == "ok" and got[5] == ["async"]


def _refusals(pkg):
    """A replica's write, and a MAIN fenced by a replica of a newer epoch:
    REGISTER REPLICA, then a write."""
    mctx, rctx = context(pkg), context(pkg)
    main = PKGS[pkg][0].Interpreter(mctx)
    rep = PKGS[pkg][0].Interpreter(rctx)
    try:
        rep.execute("SET REPLICATION ROLE TO REPLICA WITH PORT 0")
        out = [_outcome(lambda: rep.execute("CREATE (:X)"))]
        rctx.replication.set_role_replica(
            "127.0.0.1", rctx.replication.replica_server.port, epoch=3)
        port = rctx.replication.replica_server.port
        out.append(_outcome(lambda: main.execute(
            f"REGISTER REPLICA r1 SYNC TO '127.0.0.1:{port}'")))
        out.append(_outcome(lambda: main.execute("CREATE (:X)")))
        out.append(list(mctx.replication.fencing_info()))
        out.append(main.execute("MATCH (n) RETURN count(n)")[1])
        return out
    finally:
        for ctx in (mctx, rctx):
            if getattr(ctx, "replication", None) is not None:
                ctx.replication.shutdown()


def test_write_refusals_have_the_reference_types_and_messages():
    """The replica's refusal and the fencing of a MAIN by a replica of a
    newer epoch are the reference's; then the fenced MAIN, left without
    replicas, acks a write in the reference and refuses it in the port
    (ROADMAP Queue 3 item 18)."""
    want, got = _refusals("jax"), _refusals("torch")
    assert got[:2] == want[:2] and got[3] == want[3]
    assert got[0] == ("QueryException: write queries are forbidden on a "
                      "REPLICA instance")
    assert got[1].startswith("FencedException: fenced: a main with epoch 3")
    assert got[3] == [3, True]
    assert want[2] == "ok" and want[4] == [[1]]          # the reference acks
    assert got[2] == ("FencedException: write queries are forbidden: this "
                      "MAIN was deposed (fenced); reconnect via the "
                      "coordinator routing table")
    assert got[4] == [[0]]


def _system_node(pkg):
    dbms = (TDbms(recover_on_startup=False, device="cpu") if pkg == "torch"
            else JDbms(recover_on_startup=False))
    ictx = dbms.get("memgraph")
    ictx.auth_store = TAuth() if pkg == "torch" else JAuth()
    ictx.auth_store.create_user("root", "rootpw")
    interp = PKGS[pkg][0].Interpreter(ictx)
    interp.username = "root"
    return ictx, interp


@pytest.mark.parametrize("mpkg,rpkg", [("torch", "torch"), ("jax", "torch"),
                                       ("torch", "jax")])
def test_users_and_tenants_reach_the_replica_and_survive_promotion(mpkg, rpkg):
    mctx, main = _system_node(mpkg)
    rctx, rep = _system_node(rpkg)
    try:
        main.execute("CREATE USER grace IDENTIFIED BY 's3cret'")
        main.execute("CREATE DATABASE ml")
        rep.execute("SET REPLICATION ROLE TO REPLICA WITH PORT 0")
        port = rctx.replication.replica_server.port
        main.execute(f"REGISTER REPLICA r1 SYNC TO '127.0.0.1:{port}'")
        # before the registration: the full-state catch-up
        assert rctx.auth_store.authenticate("grace", "s3cret")
        assert "ml" in rctx.dbms.names()
        # after it: ordered system transactions
        main.execute("CREATE USER ada IDENTIFIED BY 'pw1'")
        main.execute("CREATE ROLE analyst")
        main.execute("GRANT MATCH TO analyst")
        main.execute("SET ROLE FOR ada TO analyst")
        main.execute("CREATE DATABASE analytics")
        main.execute("DROP DATABASE ml")
        main.execute("CREATE (:Doc {id: 1})")
        assert rctx.auth_store.user_roles("ada") == ["analyst"]
        assert rctx.auth_store.authenticate("ada", "pw1")
        assert sorted(rctx.dbms.names()) == sorted(mctx.dbms.names())
        # the MAIN dies; the replica is promoted with all of it
        mctx.replication.shutdown()
        rep.execute("SET REPLICATION ROLE TO MAIN")
        assert rep.execute("MATCH (n:Doc) RETURN n.id")[1] == [[1]]
        assert rctx.auth_store.has_privilege("ada", "MATCH")
        rep.execute("CREATE USER next IDENTIFIED BY 'x'")
        assert "next" in rctx.auth_store.users()
    finally:
        for ctx in (mctx, rctx):
            if getattr(ctx, "replication", None) is not None:
                ctx.replication.shutdown()
