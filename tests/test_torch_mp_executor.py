"""The port's multiprocess read executor (memgraph_tpu_torch/server/
mp_executor.py) on the CPU: the cases of tests/test_mp_executor.py
(snapshot semantics, parallel dispatch, typed error transport, refresh,
the respawn of a crashed worker), plus the device rule the reference
states and does not keep (ROADMAP Queue 3 item 15): a plan that runs the
compiled read lane or calls a procedure is refused in the worker with
``DeviceWorkRefused``, decided from the plan, and no worker calls
``torch.cuda``.  The lane is planned for any label scan under an
aggregate (its row threshold is checked only as it runs), so the
reference's ``MATCH (n:User) RETURN count(n)`` is refused in a worker:
those cases count through ``WITH n`` (``COUNT``), which plans no lane."""

import json
import os
import signal
import subprocess
import sys
import threading

import pytest
import torch

from memgraph_tpu_torch.exceptions import (DeviceWorkRefused,
                                           QueryException, SyntaxException,
                                           WorkerCrashedError)
from memgraph_tpu_torch.query import Interpreter
from memgraph_tpu_torch.query.frontend import ast as A
from memgraph_tpu_torch.query.interpreter import InterpreterContext
from memgraph_tpu_torch.server.mp_executor import (MPReadExecutor,
                                                   device_reason)
from memgraph_tpu_torch.storage import InMemoryStorage
from memgraph_tpu_torch.utils.metrics import global_metrics
from memgraph_tpu_torch.utils.retry import RetryPolicy

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the reference cases' count, in a form that plans no lane
COUNT = "MATCH (n:User) WITH n RETURN count(n)"


@pytest.fixture
def ictx():
    ictx = InterpreterContext(InMemoryStorage(), device="cpu")
    Interpreter(ictx).execute(
        "UNWIND range(0, 99) AS i CREATE (:User {id: i, age: i % 50})")
    return ictx


def test_reads_match_in_process(ictx):
    ex = MPReadExecutor(ictx, n_workers=2)
    try:
        cols, rows = ex.execute(
            "MATCH (n:User {id: 7}) RETURN n.age")
        assert rows == [[7]]
        cols, rows = ex.execute(COUNT)
        assert rows == [[100]]
    finally:
        ex.close()


def test_snapshot_staleness_and_refresh(ictx):
    ex = MPReadExecutor(ictx, n_workers=2)
    try:
        Interpreter(ictx).execute("CREATE (:User {id: 1000, age: 1})")
        # workers still see the fork-time snapshot
        _, rows = ex.execute(COUNT)
        assert rows == [[100]]
        ex.refresh()
        assert ex.fork_s > 0
        _, rows = ex.execute(COUNT)
        assert rows == [[101]]
    finally:
        ex.close()


def test_concurrent_dispatch(ictx):
    ex = MPReadExecutor(ictx, n_workers=4)
    results = []
    errors = []

    def worker():
        try:
            for _ in range(25):
                _, rows = ex.execute(
                    "MATCH (n:User) WHERE n.age > 10 WITH n RETURN count(n)")
                results.append(rows[0][0])
        except Exception as e:  # noqa: BLE001
            errors.append(e)
    try:
        threads = [threading.Thread(target=worker) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        assert len(results) == 100 and len(set(results)) == 1
    finally:
        ex.close()


def test_worker_error_transport(ictx):
    """Worker-side errors cross the fork boundary TYPED: the parent
    re-raises the taxonomy class the worker named, not a stringly
    RuntimeError."""
    ex = MPReadExecutor(ictx, n_workers=1)
    try:
        with pytest.raises(SyntaxException):
            ex.execute("MATCH (n RETURN n")
        # the worker survives the error
        _, rows = ex.execute("RETURN 1")
        assert rows == [[1]]
    finally:
        ex.close()


def test_write_queries_rejected_loudly(ictx):
    """Misrouted writes must fail, not vanish into the forked snapshot."""
    ex = MPReadExecutor(ictx, n_workers=1)
    try:
        with pytest.raises(QueryException, match="read-only"):
            ex.execute("CREATE (:Ghost {id: 1})")
        with pytest.raises(QueryException, match="read-only"):
            ex.execute("MATCH (n:User {id: 1}) SET n.age = 99")
        # non-Cypher statements (auth/DDL) are refused before prepare
        with pytest.raises(QueryException, match="read-only"):
            ex.execute("CREATE INDEX ON :User(id)")
        with pytest.raises(QueryException, match="read-only"):
            ex.execute("CREATE USER ghost IDENTIFIED BY 'pw'")
        # worker still serves reads afterwards
        _, rows = ex.execute(COUNT)
        assert rows == [[100]]
    finally:
        ex.close()
    # nothing leaked into the parent either
    _, rows, _ = Interpreter(ictx).execute(
        "MATCH (n:Ghost) RETURN count(n)")
    assert rows == [[0]]


def _metric(name):
    return {n: v for n, _k, v in global_metrics.snapshot()}.get(name, 0.0)


def test_worker_crash_respawns_with_typed_retryable_error(ictx):
    """A SIGKILLed worker must not wedge its queue: the in-flight job
    fails with the typed retryable WorkerCrashedError, the worker is
    respawned in place, and the respawn counter moves."""
    ex = MPReadExecutor(ictx, n_workers=2)
    try:
        assert ex.execute(COUNT)[1] == [[100]]
        respawns0 = _metric("mp_executor.worker_respawn_total")
        for pid, _rq, _rs in list(ex._workers):
            os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, 0)
        crashes = 0
        for _ in range(2):
            try:
                ex.execute(COUNT)
            except WorkerCrashedError as e:
                # RetryPolicy-compatible: ConnectionError is in the MRO
                assert isinstance(e, ConnectionError)
                crashes += 1
        assert crashes == 2
        assert _metric("mp_executor.worker_respawn_total") == \
            respawns0 + 2
        # both workers are fresh and serving again
        for _ in range(4):
            assert ex.execute(COUNT)[1] == [[100]]
    finally:
        ex.close()


def test_worker_crash_is_retry_policy_compatible(ictx):
    """RetryPolicy.call's default retry_on catches the crash error —
    the dispatch loop heals without special-casing."""
    ex = MPReadExecutor(ictx, n_workers=1)
    try:
        pid = ex._workers[0][0]
        os.kill(pid, signal.SIGKILL)
        os.waitpid(pid, 0)
        policy = RetryPolicy(base_delay=0.01, max_retries=3)
        _cols, rows = policy.call(
            lambda: ex.execute(COUNT))
        assert rows == [[100]]
    finally:
        ex.close()


def test_close_idempotent(ictx):
    ex = MPReadExecutor(ictx, n_workers=1)
    ex.close()
    ex.close()
    with pytest.raises(RuntimeError):
        ex.execute("RETURN 1")


# --- the device rule ----------------------------------------------------------

#: a lane-shaped read (a label scan counted on the device) and a CALL
LANE_READ = "MATCH (n:User) WHERE n.age < 20 RETURN count(n)"
LANE_2HOP = ("MATCH (n:User)-[:F]->()-[:F]->(m) WHERE n.id < 30 "
             "RETURN count(m)")
CALLS = ["CALL pagerank.get() YIELD node, rank RETURN node.id, rank",
         "CALL degree_centrality.get() YIELD node, degree RETURN count(*)",
         "PROFILE CALL pagerank.get() YIELD node, rank RETURN count(*)"]


@pytest.fixture
def lane_ictx(ictx, monkeypatch):
    """100 users, 300 edges, the lane's row threshold under them (read per
    call, and inherited by a forked worker)."""
    monkeypatch.setenv("MEMGRAPH_TPU_LANE_MIN_ROWS", "50")
    it = Interpreter(ictx)
    it.execute("UNWIND range(0, 299) AS k MATCH (a:User {id: k % 100}), "
               "(b:User {id: (k * 37 + 11) % 100}) CREATE (a)-[:F]->(b)")
    return ictx


def _reason(ictx, query):
    return device_reason(ictx, query, ictx.cached_parse(query))


def test_the_rule_is_read_from_the_plan(lane_ictx):
    for q in (LANE_READ, LANE_2HOP):
        plan = lane_ictx.cached_plan(q, lane_ictx.cached_parse(q))[0]
        assert getattr(plan, "_has_lane", False), q
        assert "lane" in _reason(lane_ictx, q)
    for q in CALLS:
        assert "procedure" in _reason(lane_ictx, q)
    assert _reason(lane_ictx, "MATCH (n:User {id: 7}) RETURN n.age") is None
    assert _reason(lane_ictx, "RETURN 1") is None
    assert isinstance(lane_ictx.cached_parse(CALLS[0]), A.CypherQuery)


@pytest.mark.parametrize("query", [LANE_READ, LANE_2HOP] + CALLS)
def test_device_work_is_refused_in_a_worker_and_runs_in_process(lane_ictx,
                                                                 query):
    ex = MPReadExecutor(lane_ictx, n_workers=1)
    try:
        with pytest.raises(DeviceWorkRefused, match="in process"):
            ex.execute(query)
        # the worker goes on serving host reads
        assert ex.execute("MATCH (n:User {id: 7}) RETURN n.age")[1] == [[7]]
    finally:
        ex.close()
    # the caller runs the refused query on its own interpreter
    rows = Interpreter(lane_ictx).execute(query)[1]
    assert rows


def test_a_worker_never_calls_torch_cuda(lane_ictx, monkeypatch, tmp_path):
    """Every torch.cuda entry a query could reach records its caller's pid
    (the record survives a fork); the workers serve, refuse and exit, and
    no worker pid is recorded."""
    log = tmp_path / "cuda_calls"
    names = ("is_available", "device_count", "current_device",
             "synchronize", "set_device", "_lazy_init", "init",
             "current_stream", "empty_cache", "get_device_name")

    def recorder(name):
        def called(*args, **kw):
            with open(log, "a") as f:
                f.write(f"{os.getpid()} {name}\n")
            raise RuntimeError(f"torch.cuda.{name} called")
        return called

    Interpreter(lane_ictx).execute("CREATE INDEX ON :User(id)")
    for name in names:
        monkeypatch.setattr(torch.cuda, name, recorder(name))
    ex = MPReadExecutor(lane_ictx, n_workers=2)
    pids = [w[0] for w in ex._workers]
    try:
        for _ in range(2):
            assert ex.execute("MATCH (n:User {id: 9}) RETURN n.age")[1] == \
                [[9]]
            for q in [LANE_READ] + CALLS:
                with pytest.raises(DeviceWorkRefused):
                    ex.execute(q)
    finally:
        ex.close()
    for pid in pids:        # close() reaped every worker
        with pytest.raises(ChildProcessError):
            os.waitpid(pid, os.WNOHANG)
    assert not log.exists(), log.read_text()


def test_the_reference_runs_a_device_call_in_its_worker():
    """ROADMAP Queue 3 item 15: memgraph_tpu/server/mp_executor.py says
    device queries are refused in its workers, and runs them: on a graph
    of 10 vertices without edges its forked worker answers ``CALL
    pagerank.get()`` with ranks of 0.1.  (In a subprocess of its own, so
    that a JAX runtime in a forked child cannot hold up this process.)"""
    script = (
        "import json\n"
        "from memgraph_tpu.query import Interpreter\n"
        "from memgraph_tpu.query.interpreter import InterpreterContext\n"
        "from memgraph_tpu.server.mp_executor import MPReadExecutor\n"
        "from memgraph_tpu.storage import InMemoryStorage\n"
        "ictx = InterpreterContext(InMemoryStorage())\n"
        "Interpreter(ictx).execute('UNWIND range(0, 9) AS i "
        "CREATE (:N {id: i})')\n"
        "ex = MPReadExecutor(ictx, n_workers=1)\n"
        "try:\n"
        "    _, rows = ex.execute('CALL pagerank.get() YIELD node, rank "
        "RETURN node.id AS id, rank')\n"
        "finally:\n"
        "    ex.close()\n"
        "print(json.dumps(rows))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.run([sys.executable, "-c", script], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    rows = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(rows) == 10
    assert all(abs(rank - 0.1) < 1e-6 for _id, rank in rows)
