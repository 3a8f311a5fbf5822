"""The port's shard plane (memgraph_tpu_torch/sharding/) against the JAX
package's on the CPU.

- ``shard_for_key`` is the reference's on ints, integral floats, floats,
  strings, bytes and bools (hypothesis), at 1 to 16 shards.
- ``plan_merge`` / ``merge_rows`` answer a table of queries and row sets
  as the reference's do, refusals (``MergeError``) included.
- A 4-worker plane in each package, the same script: routed writes and
  point reads, scatter reads (aggregates merged, ORDER BY / LIMIT,
  DISTINCT), a cross-shard 2PC commit and a presumed abort, a shard move,
  a worker killed and respawned with its WAL recovered: the same answers.
  The scatter reads pass their rows through ``WITH n``: a label scan
  straight under an aggregate, an ORDER BY or a DISTINCT plans the
  compiled read lane, which a shard worker refuses (the read pool's
  rule, server/mp_executor.py).
- The device rule: a shard worker refuses a plan that reaches the device
  (a procedure call, a compiled read lane) with ``DeviceWorkRefused``,
  shipped home typed, where the reference's worker runs PageRank over
  its own hash range (ROADMAP Queue 3 item 19); a worker never calls
  ``torch.cuda``.
"""

import json
import os
import signal
import subprocess
import sys

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from memgraph_tpu.sharding import partition as jpart
from memgraph_tpu.sharding import plane as jplane
from memgraph_tpu.sharding import router as jrouter
from memgraph_tpu_torch.exceptions import DeviceWorkRefused
from memgraph_tpu_torch.sharding import partition as tpart
from memgraph_tpu_torch.sharding import plane as tplane
from memgraph_tpu_torch.sharding import router as trouter

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

PKG = {"jax": (jplane, jrouter), "torch": (tplane, trouter)}
HERE = os.path.dirname(os.path.abspath(__file__))


def in_subprocess(call: str):
    """The JSON of ``call`` (an expression over this module's names) run
    in a fresh interpreter: the reference's shard workers are forked, and
    a JAX runtime this process already started must not be forked into
    them (its threads do not survive a fork)."""
    script = ("import json, sys\n"
              f"sys.path.insert(0, {HERE!r})\n"
              "import test_torch_sharding as T\n"
              f"print(json.dumps(T.{call}))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.dirname(HERE) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          cwd=os.path.dirname(HERE), capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])

KEYS = st.one_of(
    st.integers(min_value=-2 ** 63, max_value=2 ** 63 - 1),
    st.integers(min_value=-2 ** 53, max_value=2 ** 53).map(float),
    st.floats(allow_nan=False, allow_infinity=False),
    st.text(max_size=12), st.binary(max_size=12), st.booleans(),
    st.none())


def _outcome(fn, *args):
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        return type(e).__name__


@settings(max_examples=300, deadline=None)
@given(key=KEYS, n=st.integers(min_value=1, max_value=16))
def test_shard_for_key_is_the_references(key, n):
    """Equal shards, and equal refusals: an integral float past int64
    raises ``struct.error`` in both (a quirk copied, ROADMAP Queue 3
    item 20)."""
    assert _outcome(tpart.shard_for_key, key, n) == \
        _outcome(jpart.shard_for_key, key, n)
    assert _outcome(tpart.canonical_key_bytes, key) == \
        _outcome(jpart.canonical_key_bytes, key)


def test_an_integral_float_past_int64_is_refused_in_both():
    for mod in (tpart, jpart):
        with pytest.raises(Exception) as e:
            mod.shard_for_key(2.0 ** 63, 4)
        assert type(e.value).__name__ == "error"     # struct.error


MERGES = [
    ("MATCH (n) RETURN n.g, count(n), sum(n.v)",
     [[["a", 2, 10], ["b", 1, 5]], [["a", 3, 7]], []]),
    ("MATCH (n) RETURN min(n.v), max(n.v), count(*)",
     [[[1, 9, 4]], [[None, None, 0]], [[-3, 2, 2]]]),
    ("MATCH (n) RETURN n.v ORDER BY n.v LIMIT 3", [[[5], [1]], [[3], [2]]]),
    ("MATCH (n) RETURN n.v ORDER BY n.v DESC",
     [[[True], [2.5]], [["x"], [None]], [[[1, 2]], [{"k": 1}]]]),
    ("MATCH (n) RETURN DISTINCT n.g ORDER BY n.g",
     [[["b"], ["a"]], [["a"], ["c"]]]),
    ("MATCH (n) RETURN n.id, n.age ORDER BY n.age DESC, n.id ASC LIMIT $k",
     [[[1, 30], [2, 40]], [[3, 40], [4, 10]]]),
    ("MATCH (n) RETURN avg(n.v)", None),
    ("MATCH (n) RETURN count(DISTINCT n.g)", None),
    ("MATCH (n) RETURN count(n) + 1", None),
    ("MATCH (n) RETURN n.id ORDER BY n.id SKIP 5 LIMIT 5", None),
    ("MATCH (n) WITH count(n) AS c RETURN c", None),
    ("MATCH (n) RETURN n.g, count(n) LIMIT 2", None),
    ("MATCH (n) RETURN *", None),
    ("MATCH (n) RETURN n.v ORDER BY n.w", None),
    ("CREATE (n)", None),
]


def _merged(router, query, shard_rows):
    try:
        plan = router.plan_merge(query, {"k": 2})
    except router.MergeError as e:
        return ("MergeError", str(e))
    if shard_rows is None:
        return ("plan", plan.columns)
    return ("rows", router.merge_rows(plan, shard_rows))


@pytest.mark.parametrize("query,shard_rows", MERGES,
                         ids=[q for q, _ in MERGES])
def test_merge_answers_as_the_reference(query, shard_rows):
    want = _merged(jrouter, query, shard_rows)
    got = _merged(trouter, query, shard_rows)
    assert got == want
    assert (got[0] == "MergeError") == (shard_rows is None)


def _two_keys_on_distinct_shards(client):
    first = 0
    for k in range(1, 64):
        if client.shard_for(k) != client.shard_for(first):
            return first, k
    raise AssertionError("no two keys on distinct shards")


def plane_script(pkg):
    """The same requests against a 4-worker plane of ``pkg``."""
    plane_mod, router = PKG[pkg]
    plane = plane_mod.ShardPlane(n_shards=4).start()
    client = router.ShardedClient(plane)
    out = {}
    try:
        client.ddl("CREATE INDEX ON :User(id)")
        for i in range(80):
            client.write("CREATE (:User {id: $id, age: $age, grp: $grp})",
                         {"id": i, "age": (i * 7) % 50, "grp": i % 3}, key=i)
        out["point"] = [client.read("MATCH (n:User {id: $id}) RETURN n.age",
                                    {"id": i}, key=i)[1] for i in (0, 7, 79)]
        scatter = [
            "MATCH (n:User) WITH n RETURN count(n) AS c",
            "MATCH (n:User) WITH n RETURN sum(n.age) AS s, min(n.age), "
            "max(n.age)",
            "MATCH (n:User) WITH n RETURN n.grp AS g, count(n) AS c "
            "ORDER BY g",
            "MATCH (n:User) WITH n WHERE n.age > 20 RETURN n.id, n.age "
            "ORDER BY n.age DESC, n.id ASC LIMIT 7",
            "MATCH (n:User) WITH n RETURN DISTINCT n.grp ORDER BY n.grp",
        ]
        out["scatter"] = [client.read(q)[1] for q in scatter]
        k1, k2 = _two_keys_on_distinct_shards(client)
        res = client.write_multi([
            (k1, "MATCH (n:User {id: $id}) SET n.age = 100", {"id": k1}),
            (k2, "MATCH (n:User {id: $id}) SET n.age = 200", {"id": k2})])
        out["2pc"] = (sorted(res["shards"]) == sorted(
            {client.shard_for(k1), client.shard_for(k2)}), res["epoch"])
        try:
            client.write_multi([
                (k1, "MATCH (n:User {id: $id}) SET n.age = 1", {"id": k1}),
                (k2, "THIS IS NOT CYPHER", None)])
            out["abort"] = "committed"
        except Exception as e:  # noqa: BLE001 — the outcome is compared
            out["abort"] = type(e).__name__
        out["after_2pc"] = [client.read(
            "MATCH (n:User {id: $id}) RETURN n.age", {"id": k}, key=k)[1]
            for k in (k1, k2)]
        plane.shard_move(2)
        client.refresh_map()
        out["moved"] = client.read(
            "MATCH (n:User) WITH n RETURN count(n) AS c")[1]
        # a worker killed: the next request respawns it from its WAL
        pid = plane.kill_worker(1)
        out["respawned"] = client.read(
            "MATCH (n:User) WITH n RETURN count(n) AS c, sum(n.age) AS s")[1]
        out["new_pid"] = plane.owner(1).pid != pid
        out["epoch"] = client.map.epoch
        out["wal_dirs"] = sorted(d for d in os.listdir(plane.base_dir)
                                 if d.startswith("shard_"))
        out["respawn_s"] = getattr(plane, "respawn_s", None)
        return out
    finally:
        plane.close()


@pytest.fixture(scope="module")
def planes():
    return {"jax": in_subprocess('plane_script("jax")'),
            "torch": json.loads(json.dumps(plane_script("torch")))}


def test_a_plane_answers_as_the_references(planes):
    want, got = planes["jax"], planes["torch"]
    respawn_s = got.pop("respawn_s")
    assert want.pop("respawn_s") is None
    assert got == want
    assert got["point"] == [[[0]], [[49]], [[3]]]
    assert got["scatter"][0] == [[80]]
    assert got["2pc"][0] is True and got["abort"] == "SyntaxException"
    assert got["after_2pc"] == [[[100]], [[200]]]
    assert got["moved"] == [[80]] and got["respawned"][0][0] == 80
    assert got["new_pid"] is True
    assert respawn_s is not None and respawn_s > 0


CALL = "CALL pagerank.get() YIELD node, rank RETURN node.id AS id, rank"


def device_probe(pkg):
    """A routed CALL and a lane-shaped scatter count on a 4-worker plane
    of ``pkg`` (40 users, one follow): their outcomes, a host-path count,
    and the users on the CALL's shard."""
    plane_mod, router = PKG[pkg]
    plane = plane_mod.ShardPlane(n_shards=4).start()
    client = router.ShardedClient(plane)
    try:
        for i in range(40):
            client.write("CREATE (:User {id: $id})", {"id": i}, key=i)
        client.write("MATCH (a:User {id: 0}), (b:User {id: 4}) "
                     "CREATE (a)-[:F]->(b)", key=0)
        out = []
        for query, key in ((CALL, 0), ("MATCH (n:User) RETURN count(n)",
                                       None)):
            try:
                out.append(["rows", client.read(query, key=key)[1]])
            except Exception as e:  # noqa: BLE001 — compared below
                out.append([type(e).__name__, str(e)])
        out.append(client.read("MATCH (n:User) WITH n "
                               "RETURN count(n) AS c")[1])
        on_shard = sum(1 for i in range(40)
                       if client.shard_for(i) == client.shard_for(0))
        return out, on_shard
    finally:
        plane.close()


def test_a_shard_worker_refuses_device_work_the_reference_runs():
    """ROADMAP Queue 3 item 19: the reference's worker answers a routed
    ``CALL pagerank.get()`` with PageRank over its own hash range (and
    runs the compiled lane); the port's refuses both, typed."""
    jout, on_shard0 = in_subprocess('device_probe("jax")')
    tout, _ = device_probe("torch")
    # the reference: one hash range's PageRank, and the lane's count
    assert jout[0][0] == "rows" and len(jout[0][1]) == on_shard0 < 40
    assert jout[1] == ["rows", [[40]]]
    assert tout[0][0] == "DeviceWorkRefused"
    assert "calls procedure pagerank.get" in tout[0][1]
    assert tout[1][0] == "DeviceWorkRefused"
    assert "compiled read lane" in tout[1][1]
    assert tout[2] == jout[2] == [[40]]


def test_a_shard_worker_never_calls_torch_cuda(monkeypatch, tmp_path):
    """Every torch.cuda entry a request could reach records its caller's
    pid (the record survives the fork); the workers serve, refuse, move,
    respawn and exit, and no worker pid is recorded."""
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

    for name in names:
        monkeypatch.setattr(torch.cuda, name, recorder(name))
    plane = tplane.ShardPlane(n_shards=2).start()
    client = trouter.ShardedClient(plane)
    try:
        for i in range(10):
            client.write("CREATE (:User {id: $id})", {"id": i}, key=i)
        assert client.read("MATCH (n:User) WITH n RETURN count(n) AS c")[1] \
            == [[10]]
        with pytest.raises(DeviceWorkRefused):
            client.read(CALL, key=1)
        plane.shard_move(0)
        plane.kill_worker(1)
        client.refresh_map()
        assert client.read("MATCH (n:User) WITH n RETURN count(n) AS c")[1] \
            == [[10]]
    finally:
        plane.close()
    assert not log.exists(), log.read_text()


def test_a_worker_forked_while_another_thread_holds_a_registry_lock_starts():
    """ROADMAP Queue 3 item 21: a child inherits every lock as it was at
    the fork.  With another thread holding the metrics and query-stats
    locks (as a scatter read's sibling threads do while one of them
    respawns a dead owner), the port's workers start and serve: the
    child renews them (``utils.locks.fork_safe``)."""
    import threading

    from memgraph_tpu_torch.observability.stats import global_query_stats
    from memgraph_tpu_torch.utils.metrics import global_metrics
    held, release = threading.Event(), threading.Event()

    def hold():
        with global_metrics._lock, global_query_stats._lock:
            held.set()
            release.wait(60)

    holder = threading.Thread(target=hold)
    holder.start()
    assert held.wait(10)
    plane, served = None, {}

    def start():
        nonlocal plane
        plane = tplane.ShardPlane(n_shards=2)
        # the forks happen here, the locks held by the other thread
        for sid in range(2):
            plane._workers[sid] = plane._spawn(sid, generation=0)
        release.set()
        plane.map = plane.placement.assign(0, plane._workers[0].name)
        plane.map = plane.placement.assign(1, plane._workers[1].name)
        plane._broadcast_grant()
        client = trouter.ShardedClient(plane)
        for i in range(6):
            client.write("CREATE (:User {id: $id})", {"id": i}, key=i)
        served["count"] = client.read(
            "MATCH (n:User) WITH n RETURN count(n) AS c")[1]

    starter = threading.Thread(target=start, daemon=True)
    starter.start()
    starter.join(60)
    release.set()
    holder.join(60)
    hung = starter.is_alive()
    if hung and plane is not None:
        # a worker stuck on a lock: end it rather than leave it running
        for w in list(plane._workers.values()):
            try:
                os.kill(w.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        starter.join(60)
    try:
        assert not hung, "a forked worker hung on a lock"
        assert served["count"] == [[6]]
    finally:
        if plane is not None:
            plane.close()
