"""The port's Cypher engine (memgraph_tpu_torch/query, storage) against the
JAX package's on the CPU.

Each script runs statement by statement through the JAX package's
``Interpreter`` and through the port's (``device="cpu"``), each on a fresh
storage of its own package.  Every statement's columns, rows and summary
statistics, or its error (class name and message), are compared exactly,
after one normalisation: a node becomes its gid, label names and
properties, a relationship its gid, type, endpoints and properties, a
path its items, and a temporal or spatial value its type name and text.

Also here: the compiled read lane's answers and its lane-or-fallback
decisions on lane-shaped reads above ``LANE_MIN_ROWS`` (the same counts
per fingerprint in both registries); the device rule of the port's
``InterpreterContext`` (it raises without a card unless asked for the
CPU); the typed refusal of each query family that a later slice brings;
the families of the Bolt entry point's slice (auth, profiles,
multi-database, the license) against the JAX interpreter; and an import
of the whole port with ``jax`` and ``memgraph_tpu`` blocked.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from memgraph_tpu.ops import pipeline as jpipe
from memgraph_tpu.query import interpreter as jinterp
from memgraph_tpu.storage import InMemoryStorage as JStorage
from memgraph_tpu_torch.exceptions import NotPortedException
from memgraph_tpu_torch.ops import pipeline as tpipe
from memgraph_tpu_torch.query import interpreter as tinterp
from memgraph_tpu_torch.query.plan import lane as tlane
from memgraph_tpu_torch.storage import InMemoryStorage as TStorage

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def normalise(v):
    """A result value in a form both packages share (see the module
    docstring)."""
    if hasattr(v, "vertex") and hasattr(v, "labels"):
        st = v._acc.storage
        return ("node", int(v.gid),
                tuple(sorted(st.label_mapper.id_to_name(lb)
                             for lb in v.labels())),
                tuple(sorted((st.property_mapper.id_to_name(k),
                              normalise(x))
                             for k, x in v.properties().items())))
    if hasattr(v, "edge") and hasattr(v, "edge_type"):
        st = v._acc.storage
        return ("rel", int(v.gid), st.edge_type_mapper.id_to_name(v.edge_type),
                int(v.from_vertex().gid), int(v.to_vertex().gid),
                tuple(sorted((st.property_mapper.id_to_name(k),
                              normalise(x))
                             for k, x in v.properties().items())))
    if type(v).__name__ == "Path" and hasattr(v, "items"):
        return ("path", tuple(normalise(x) for x in v.items))
    if isinstance(v, dict):
        return ("map", tuple(sorted((k, normalise(x))
                                    for k, x in v.items())))
    if isinstance(v, (list, tuple)):
        return tuple(normalise(x) for x in v)
    if v is None or isinstance(v, (bool, int, float, str, bytes)):
        return v
    return (type(v).__name__, str(v))


def run(interp, query, params=None):
    """One statement's outcome: ("ok", columns, rows, stats) or ("error",
    class name, message)."""
    try:
        cols, rows, summary = interp.execute(query, params)
    except Exception as e:  # noqa: BLE001 — the error is the outcome
        try:
            interp.abort()
        except Exception:  # noqa: BLE001
            pass
        return ("error", type(e).__name__, str(e))
    rows = [normalise(r) for r in rows]
    if query.strip().upper().startswith("EXPLAIN"):
        # an unnamed pattern element's symbol carries a process-wide
        # counter (``__edge5__``): its number depends on what was parsed
        # before in the process
        rows = [tuple(re.sub(r"__([a-z]+)\d+__", r"__\1__", x)
                      for x in r) for r in rows]
    if query.strip().upper().startswith("SHOW INDEX INFO"):
        # last_used is the wall clock of the lookup: whether it is set
        rows = [r[:-1] + (r[-1] is not None,) for r in rows]
    return ("ok", list(cols), rows, (summary or {}).get("stats"))


def pair():
    """A JAX-package interpreter and a port one, each on a fresh
    storage."""
    j = jinterp.Interpreter(jinterp.InterpreterContext(JStorage()))
    t = tinterp.Interpreter(tinterp.InterpreterContext(TStorage(),
                                                       device="cpu"))
    return j, t


GRAPH = [
    "CREATE (a:Person {name: 'Ann', age: 30, tags: ['x', 'y']}), "
    "(b:Person {name: 'Bob', age: 25}), (c:Person:Admin {name: 'Cy', age: 41}), "
    "(d:City {name: 'Oslo', pop: 700000}), (e:City {name: 'Rome'}), "
    "(a)-[:KNOWS {since: 2010, w: 1.5}]->(b), (b)-[:KNOWS {since: 2015, w: 0.5}]->(c), "
    "(c)-[:KNOWS {since: 2001, w: 2.0}]->(a), (a)-[:LIVES_IN]->(d), "
    "(b)-[:LIVES_IN]->(d), (c)-[:LIVES_IN]->(e), (a)-[:KNOWS {since: 2020, w: 3.0}]->(c)",
]

#: name -> statements (each a query or (query, params))
SCRIPTS = {
    "create_match": GRAPH + [
        "MATCH (p:Person) RETURN p ORDER BY p.name",
        "MATCH (n) RETURN labels(n), n.name ORDER BY n.name",
        "MATCH (a)-[r:KNOWS]->(b) RETURN a.name, r, b.name ORDER BY r.since",
        "MATCH (a:Person {name: 'Ann'})-[:KNOWS]->(b) RETURN b.name ORDER BY b.name",
        "MATCH (c:City) WHERE c.pop IS NULL RETURN c"],
    "create_return": [
        "CREATE (n:X {a: 1, b: [1, 2.5, 'z'], c: {k: true}}) RETURN n, n.b, n.c",
        "CREATE (a:X)-[r:R {p: 'q'}]->(b:Y) RETURN a, r, b",
        "MATCH (n) RETURN count(n)"],
    "merge": GRAPH + [
        "MERGE (n:City {name: 'Oslo'}) ON MATCH SET n.seen = true RETURN n",
        "MERGE (n:City {name: 'Paris'}) ON CREATE SET n.new = 1 RETURN n",
        "MATCH (a:Person {name: 'Bob'}), (c:City {name: 'Paris'}) "
        "MERGE (a)-[r:VISITED]->(c) RETURN r",
        "MATCH (a:Person {name: 'Bob'}), (c:City {name: 'Paris'}) "
        "MERGE (a)-[r:VISITED]->(c) RETURN count(r)",
        "MERGE (a:Person {name: 'Zed'})-[:KNOWS]->(b:Person {name: 'Ann'}) "
        "RETURN a.name, b.name",
        "MATCH (n) RETURN count(n)"],
    "optional_match": GRAPH + [
        "MATCH (p:Person) OPTIONAL MATCH (p)-[:LIVES_IN]->(c:City {pop: 700000}) "
        "RETURN p.name, c.name ORDER BY p.name",
        "OPTIONAL MATCH (n:Nothing) RETURN n",
        "MATCH (c:City) OPTIONAL MATCH (c)<-[:KNOWS]-(x) RETURN c.name, count(x) "
        "ORDER BY c.name"],
    "var_length": GRAPH + [
        "MATCH p = (a:Person {name: 'Ann'})-[:KNOWS*1..3]->(b) "
        "RETURN p ORDER BY length(p), b.name",
        "MATCH (a:Person {name: 'Bob'})-[r:KNOWS*2]->(b) RETURN b.name, size(r)",
        "MATCH (a:Person {name: 'Ann'})-[*0..1]-(b) RETURN DISTINCT b.name "
        "ORDER BY b.name",
        "MATCH (a {name: 'Ann'})-[:KNOWS* (e, n | e.w > 1.0)]->(b) "
        "RETURN DISTINCT b.name ORDER BY b.name"],
    "shortest_paths": GRAPH + [
        "MATCH p = shortestPath((a:Person {name: 'Bob'})-[*]-(b:City {name: 'Rome'})) "
        "RETURN length(p)",
        "MATCH p = (a:Person {name: 'Ann'})-[*BFS ..2]-(b:City) "
        "RETURN p ORDER BY b.name",
        "MATCH p = (a:Person {name: 'Bob'})-[:KNOWS *BFS]->(b:Person {name: 'Ann'}) "
        "RETURN p",
        "MATCH p = (a:Person {name: 'Ann'})-[:KNOWS *WSHORTEST (r, n | r.w) total]->"
        "(b:Person {name: 'Bob'}) RETURN p, total",
        "MATCH p = (a {name: 'Ann'})-[:KNOWS *ALLSHORTEST (r, n | r.w) total]->"
        "(b {name: 'Cy'}) RETURN p, total",
        "MATCH p = (a {name: 'Ann'})-[*ALLSHORTEST (r, n | r.w) total]->(b {name: 'Cy'}) "
        "RETURN p, total"],
    "aggregates": GRAPH + [
        "MATCH (p:Person) RETURN count(p), sum(p.age), avg(p.age), min(p.age), "
        "max(p.age), collect(p.name)",
        "MATCH (p:Person)-[:LIVES_IN]->(c) RETURN c.name, count(*) AS n, "
        "collect(p.name) AS who ORDER BY c.name",
        "MATCH (p:Person)-[k:KNOWS]->() RETURN p.name, count(DISTINCT k.since), "
        "percentileDisc(k.w, 0.5), stDev(k.w) ORDER BY p.name",
        "MATCH (n) RETURN count(n.age), count(*)",
        "UNWIND [] AS x RETURN count(x), sum(x), collect(x)"],
    "order_skip_limit": GRAPH + [
        "MATCH (n) RETURN n.name ORDER BY n.name DESC SKIP 1 LIMIT 3",
        "MATCH (p:Person) RETURN p.name, p.age ORDER BY p.age DESC, p.name LIMIT 2",
        ("MATCH (n) RETURN n.name ORDER BY n.name SKIP $s LIMIT $l",
         {"s": 2, "l": 2}),
        "MATCH (n) WITH n ORDER BY n.name LIMIT 2 RETURN collect(n.name)"],
    "unwind": [
        "UNWIND [1, 2, 3] AS x UNWIND ['a', 'b'] AS y RETURN x, y",
        "UNWIND range(1, 10, 3) AS i RETURN i * 2",
        ("UNWIND $rows AS r CREATE (:R {k: r.k, v: r.v})",
         {"rows": [{"k": i, "v": i * 1.5} for i in range(5)]}),
        "MATCH (r:R) RETURN r.k, r.v ORDER BY r.k",
        "UNWIND [[1, 2], [3], []] AS l UNWIND l AS x RETURN collect(x)"],
    "subqueries": GRAPH + [
        "MATCH (p:Person) CALL { WITH p MATCH (p)-[:KNOWS]->(f) "
        "RETURN count(f) AS friends } RETURN p.name, friends ORDER BY p.name",
        "MATCH (p:Person) WHERE exists((p)-[:LIVES_IN]->(:City {name: 'Oslo'})) "
        "RETURN p.name ORDER BY p.name",
        "MATCH (p:Person) RETURN p.name, size([(p)-[:KNOWS]->(x) | x]) AS k "
        "ORDER BY p.name",
        "CALL { MATCH (c:City) RETURN c.name AS n } RETURN n ORDER BY n",
        "UNWIND range(1, 5) AS i CALL { WITH i CREATE (:B {i: i}) } "
        "IN TRANSACTIONS OF 2 ROWS",
        "MATCH (b:B) RETURN count(b), sum(b.i)"],
    "transactions": [
        "CREATE (:T {i: 1})",
        "BEGIN",
        "CREATE (:T {i: 2})",
        "MATCH (t:T) RETURN t.i ORDER BY t.i",
        "ROLLBACK",
        "MATCH (t:T) RETURN t.i ORDER BY t.i",
        "BEGIN",
        "MATCH (t:T) SET t.i = t.i + 10",
        "CREATE (:T {i: 3})",
        "COMMIT",
        "MATCH (t:T) RETURN t.i ORDER BY t.i",
        "COMMIT",
        "ROLLBACK",
        "BEGIN",
        "BEGIN",
        "ROLLBACK",
        "SET NEXT TRANSACTION ISOLATION LEVEL READ COMMITTED",
        "MATCH (t:T) RETURN count(t)",
        "SET SESSION TRANSACTION ISOLATION LEVEL READ UNCOMMITTED",
        "MATCH (t:T) RETURN count(t)"],
    "explain": GRAPH + [
        "EXPLAIN MATCH (p:Person)-[:KNOWS]->(f) WHERE p.age > 20 "
        "RETURN f.name ORDER BY f.name LIMIT 3",
        "EXPLAIN MATCH (n) RETURN count(n)",
        "EXPLAIN CREATE (:Q)-[:R]->(:Q)",
        "EXPLAIN MATCH (a), (b) WHERE id(a) = 0 MERGE (a)-[:R]->(b)",
        "EXPLAIN CALL pagerank.get() YIELD node, rank RETURN node, rank"],
    "index_ddl": GRAPH + [
        "CREATE INDEX ON :Person(name)",
        "CREATE INDEX ON :Person",
        "CREATE INDEX ON :City(name, pop)",
        "CREATE EDGE INDEX ON :KNOWS",
        "EXPLAIN MATCH (p:Person {name: 'Bob'}) RETURN p",
        "MATCH (p:Person {name: 'Bob'}) RETURN p.age",
        "EXPLAIN MATCH (p:Person) WHERE p.name > 'A' RETURN p.name",
        "MATCH (p:Person) WHERE p.name > 'B' RETURN p.name ORDER BY p.name",
        "SHOW INDEX INFO",
        "DROP INDEX ON :Person(name)",
        "DROP EDGE INDEX ON :KNOWS",
        "SHOW INDEX INFO",
        "ANALYZE GRAPH",
        "ANALYZE GRAPH DELETE STATISTICS"],
    "constraints": GRAPH + [
        "CREATE CONSTRAINT ON (p:Person) ASSERT p.name IS UNIQUE",
        "CREATE (:Person {name: 'Ann'})",
        "CREATE CONSTRAINT ON (c:City) ASSERT EXISTS (c.name)",
        "CREATE (:City {pop: 3})",
        "CREATE CONSTRAINT ON (p:Person) ASSERT p.age IS TYPED INTEGER",
        "CREATE (:Person {name: 'Dee', age: 'old'})",
        "SHOW CONSTRAINT INFO",
        "DROP CONSTRAINT ON (p:Person) ASSERT p.name IS UNIQUE",
        "CREATE (:Person {name: 'Ann', age: 9})",
        "MATCH (p:Person {name: 'Ann'}) RETURN count(p)",
        "SHOW CONSTRAINT INFO"],
    "errors": GRAPH + [
        "MATCH (n RETURN n",
        "RETURN nosuch(1)",
        "RETURN 1 / 0",
        "RETURN 'a' - 1",
        "MATCH (p:Person {name: 'Ann'}) DELETE p",
        "RETURN x",
        "CALL nosuch.proc()",
        "MATCH (n) RETURN n.name AS a, n.age AS a",
        "CREATE (n)-[:R|S]->(m)",
        "MATCH (n) WITH n RETURN m",
        "RETURN [1, 2][5], {a: 1}.b, toInteger('x')",
        "RETURN 9223372036854775807 + 1"],
    "functions": [
        "RETURN toUpper('ab'), substring('hello', 1, 3), split('a,b', ','), "
        "replace('aXa', 'X', '-'), trim('  t '), reverse('abc'), size('four')",
        "RETURN range(0, 4), head([1, 2]), last([1, 2]), tail([1, 2, 3]), "
        "reverse([1, 2]), [x IN range(1, 6) WHERE x % 2 = 0 | x * x]",
        "RETURN abs(-3), sign(-2.5), round(2.5), floor(2.7), ceil(2.1), "
        "sqrt(16.0), 7 % 3, 2 ^ 10, toFloat('1.5'), toString(12), toBoolean('true')",
        "RETURN reduce(s = 0, x IN [1, 2, 3] | s + x), "
        "CASE WHEN 1 > 2 THEN 'a' ELSE 'b' END, coalesce(null, 3), "
        "keys({b: 1, a: 2}), 1 IN [1, 2], null = null, 'ab' STARTS WITH 'a', "
        "'ab' =~ 'a.'",
        "RETURN date('2024-02-29'), localtime('12:30:15'), "
        "localdatetime('2024-01-02T03:04:05'), duration('P1DT2H'), "
        "date('2024-01-31') + duration('P1D'), "
        "datetime('2024-01-02T03:04:05+01:00')",
        "RETURN point({x: 1.0, y: 2.0}), point.distance(point({x: 0.0, y: 0.0}), "
        "point({x: 3.0, y: 4.0}))",
        "WITH [3, 1, 2] AS l RETURN any(x IN l WHERE x > 2), all(x IN l WHERE x > 0), "
        "none(x IN l WHERE x > 5), single(x IN l WHERE x = 1)"],
    "updates": GRAPH + [
        "MATCH (p:Person {name: 'Ann'}) SET p.age = 31, p:Vip, p += {k: 1} "
        "RETURN p",
        "MATCH (p:Person {name: 'Bob'}) REMOVE p.age, p:Person RETURN p",
        "MATCH (c:City {name: 'Rome'}) DETACH DELETE c",
        "MATCH (a)-[r:KNOWS {since: 2020}]->() DELETE r",
        "MATCH (n) SET n = {name: n.name} RETURN n ORDER BY n.name",
        "MATCH (n) RETURN count(n), sum(size([(n)-->(m) | m]))",
        "MATCH ()-[r]->() RETURN type(r), count(*) ORDER BY type(r)",
        "FOREACH (i IN [1, 2] | CREATE (:F {i: i}))",
        "MATCH (f:F) RETURN f.i ORDER BY f.i"],
    "with_union_patterns": GRAPH + [
        "MATCH (p:Person) WITH p.age AS age, p WHERE age > 26 "
        "RETURN p.name ORDER BY p.name",
        "MATCH (c:City) RETURN c.name AS n UNION ALL MATCH (c:City) RETURN c.name AS n",
        "MATCH (c:City) RETURN c.name AS n UNION MATCH (c:City) RETURN c.name AS n",
        "MATCH (p:Person) RETURN p.name, [(p)-[:KNOWS]->(f) | f.name] AS fs "
        "ORDER BY p.name",
        "MATCH (a)-[r]->(b) WHERE type(r) = 'LIVES_IN' RETURN a.name, b.name "
        "ORDER BY a.name",
        "MATCH (a:Person), (b:Person) WHERE a.age < b.age RETURN a.name, b.name "
        "ORDER BY a.name, b.name"],
    "admin": GRAPH + [
        "SHOW VERSION",
        "SHOW DATABASE",
        "SET DATABASE SETTING 'hops_limit_partial_results' TO 'false'",
        "SHOW DATABASE SETTINGS",
        "SHOW TRANSACTIONS",
        "SET GLOBAL TRANSACTION ISOLATION LEVEL SNAPSHOT ISOLATION",
        "SHOW SCHEMA INFO",
        "FREE MEMORY",
        "SET STORAGE MODE IN_MEMORY_ANALYTICAL",
        "CREATE (:A {i: 1})",
        "SET STORAGE MODE IN_MEMORY_TRANSACTIONAL",
        "MATCH (a:A) RETURN a",
        "SESSION TRACE ON",
        "MATCH (n) RETURN count(n)"],
}


def _params(stmt):
    return stmt if isinstance(stmt, tuple) else (stmt, None)


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_matches_the_reference(name):
    j, t = pair()
    for i, stmt in enumerate(SCRIPTS[name]):
        query, params = _params(stmt)
        want = run(j, query, params)
        got = run(t, query, params)
        assert got == want, f"statement {i}: {query}"


def test_every_script_ran_something_on_both():
    """The scripts are not vacuous: each has rows and each category of
    outcome the parity covers occurs."""
    kinds = set()
    for name in ("create_match", "errors", "transactions"):
        _, t = pair()
        for stmt in SCRIPTS[name]:
            out = run(t, *_params(stmt))
            kinds.add(out[0])
    assert kinds == {"ok", "error"}


# --- the compiled read lane ----------------------------------------------------

N_LANE = 6000          # above LANE_MIN_ROWS (4096)
E_LANE = 12000

LANE_QUERIES = [
    ("MATCH (n:U) WHERE n.id < $k RETURN count(n)", {"k": 700}),
    ("MATCH (n:U) WHERE n.id < $k RETURN count(n)", {"k": 5500}),
    ("MATCH (n:U) WHERE n.id >= 100 AND n.grp = 3 RETURN count(n), "
     "sum(n.id), min(n.id), max(n.id)", None),
    ("MATCH (n:U)-[:F]->()-[:F]->(m) WHERE n.id < $k RETURN count(m)",
     {"k": 300}),
    ("MATCH (n:U)-[:F]->()-[:F]->(m) WHERE n.id < $k RETURN count(m)",
     {"k": 5000}),
    ("MATCH (n:U)-[:F]->(m) WHERE n.id < $k RETURN count(*)", {"k": 900}),
    ("MATCH (n:U)-[:F*1..2]->(m) WHERE n.grp = 1 RETURN count(DISTINCT m)",
     None),
    ("MATCH (n:U) WHERE n.id > 10 RETURN n.id ORDER BY n.id DESC LIMIT 5",
     None),
    ("MATCH (n:U) WHERE n.grp = 2 RETURN n.id ORDER BY n.score LIMIT 3",
     None),
    ("MATCH (n:U) RETURN n.grp, count(n) ORDER BY n.grp", None),
    ("MATCH (n:U) WHERE n.score < 0.5 RETURN count(n)", None),
    ("MATCH (n:U) WHERE n.name = 'u7' RETURN count(n)", None),
    ("MATCH (n:U) RETURN avg(n.id)", None),
]


@pytest.fixture(scope="module")
def lane_pair():
    """Both interpreters on the same graph of N_LANE vertices and E_LANE
    edges, built by Cypher (the id index serves the edge inserts and is
    dropped, so that the reads plan as label scans)."""
    rng = np.random.default_rng(11)
    pairs = rng.integers(0, N_LANE, (E_LANE, 2)).tolist()
    score = rng.random(N_LANE).round(6).tolist()
    j, t = pair()
    for it in (j, t):
        it.execute("UNWIND range(0, $n - 1) AS i CREATE (:U {id: i, "
                   "grp: i % 5, name: 'u' + toString(i % 50), "
                   "score: $s[i]})", {"n": N_LANE, "s": score})
        it.execute("CREATE INDEX ON :U(id)")
        it.execute("UNWIND $p AS p MATCH (a:U {id: p[0]}), (b:U {id: p[1]}) "
                   "CREATE (a)-[:F]->(b)", {"p": pairs})
        it.execute("DROP INDEX ON :U(id)")
    return j, t


def test_lane_answers_and_decisions_match_the_reference(lane_pair):
    j, t = lane_pair
    jpipe.LANE_REGISTRY.reset()
    tpipe.LANE_REGISTRY.reset()
    for query, params in LANE_QUERIES:
        want = run(j, query, params)
        got = run(t, query, params)
        assert got == want, query
    want = jpipe.LANE_REGISTRY.snapshot()
    got = tpipe.LANE_REGISTRY.snapshot()
    assert got == want
    hits = sum(e["hits"] for e in got.values())
    fallbacks = sum(sum(e["fallbacks"].values()) for e in got.values())
    assert hits >= 6 and fallbacks >= 2, got


def test_lane_plans_match_the_reference(lane_pair):
    j, t = lane_pair
    for query, params in LANE_QUERIES:
        assert run(t, "EXPLAIN " + query, params) == \
            run(j, "EXPLAIN " + query, params)
    assert tlane.LANE_MIN_ROWS == jpipe.LANE_MIN_ROWS


def test_a_transaction_with_its_own_writes_takes_the_host_path(lane_pair):
    _, t = lane_pair
    tpipe.LANE_REGISTRY.reset()
    query = "MATCH (n:U) WHERE n.id < 50 RETURN count(n)"
    t.execute("BEGIN")
    try:
        t.execute("CREATE (:U {id: -1})")
        assert t.execute(query)[1] == [[51]]
    finally:
        t.execute("ROLLBACK")
    fps = tpipe.LANE_REGISTRY.snapshot()
    assert [e["fallbacks"] for e in fps.values()] == [{"mvcc_private": 1}]
    assert t.execute(query)[1] == [[50]]


# --- the device rule and the families of later slices --------------------------

def test_the_context_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tinterp.InterpreterContext(TStorage())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tinterp.InterpreterContext(TStorage(), device="cuda")
    ctx = tinterp.InterpreterContext(TStorage(), device="cpu")
    assert ctx.device == torch.device("cpu")


LATER = [
    ("SET REPLICATION ROLE TO MAIN", "replication", "replication"),
    ("REGISTER REPLICA r1 SYNC TO '127.0.0.1:10000'", "replication",
     "replication"),
    ("SHOW INSTANCES", "coordinators", "replication"),
    ("SET INSTANCE i1 TO MAIN", "coordinators", "replication"),
    ("CREATE KAFKA STREAM s TOPICS t TRANSFORM m.t", "streams", "streams"),
    ("SHOW STREAMS", "streams", "streams"),
    ("CREATE TRIGGER t ON CREATE AFTER COMMIT EXECUTE CREATE (:X)",
     "triggers", "triggers"),
    ("SHOW TRIGGERS", "triggers", "triggers"),
    ("ENABLE TTL EVERY '1s'", "TTL", "TTL"),
    ("CREATE SNAPSHOT", "snapshots and recovery", "durability"),
    ("RECOVER SNAPSHOT", "snapshots and recovery", "durability"),
    ("DUMP DATABASE", "DUMP DATABASE", "dump"),
    ("CREATE ENUM Status VALUES { Active, Inactive }", "enum DDL", "enums"),
    ("SHOW ENUMS", "enum DDL", "enums"),
    ("SET STORAGE MODE ON_DISK_TRANSACTIONAL",
     "ON_DISK_TRANSACTIONAL storage", "on-disk"),
]


@pytest.mark.parametrize("query,family,slice_word", LATER,
                         ids=[q for q, _, _ in LATER])
def test_a_family_of_a_later_slice_raises_its_typed_error(query, family,
                                                         slice_word):
    _, t = pair()
    with pytest.raises(NotPortedException) as info:
        t.execute(query)
    assert info.value.family == family
    assert slice_word in info.value.slice
    # the session goes on
    assert t.execute("RETURN 1")[1] == [[1]]


#: the families of the Bolt entry point's slice: query -> statements run
#: before it (as the first user, who is then the session's user)
BOLT_SLICE = {
    "CREATE USER alice IDENTIFIED BY 'pw'": [],
    "SHOW USERS": ["CREATE USER alice IDENTIFIED BY 'pw'"],
    "GRANT MATCH TO alice": ["CREATE USER alice IDENTIFIED BY 'pw'"],
    "CREATE PROFILE p LIMIT SESSIONS 1": [],
    "CREATE TENANT PROFILE tp LIMIT memory_limit 100MB": [],
    "CREATE DATABASE db2": [],
    "SHOW DATABASES": ["CREATE DATABASE db2"],
    "SHOW LICENSE INFO": [],
}


@pytest.mark.parametrize("query", BOLT_SLICE, ids=list(BOLT_SLICE))
def test_a_family_of_the_bolt_slice_answers_as_the_reference(query):
    """Each family that waited for the Bolt entry point's slice gives the
    JAX interpreter's rows or error, on a default database of each
    package's ``DbmsHandler`` with an auth store of its own."""
    from memgraph_tpu.auth.auth import Auth as JAuth
    from memgraph_tpu.dbms.dbms import DbmsHandler as JDbms
    from memgraph_tpu_torch.auth.auth import Auth as TAuth
    from memgraph_tpu_torch.dbms.dbms import DbmsHandler as TDbms
    outs = []
    for dbms, auth, mod in ((JDbms(), JAuth(), jinterp),
                            (TDbms(device="cpu"), TAuth(), tinterp)):
        ctx = dbms.default()
        ctx.auth_store = auth
        it = mod.Interpreter(ctx)
        out = [run(it, q) for q in BOLT_SLICE[query]]
        if auth.users():
            it.username = auth.users()[0]
        out += [run(it, query), run(it, "RETURN 1")]
        outs.append(out)
    assert outs[1] == outs[0]
    assert outs[1][-2][0] == "ok" and outs[1][-1][2] == [(1,)]


def test_the_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, the Cypher engine included, imports with
    ``jax`` and ``memgraph_tpu`` made unimportable."""
    code = r"""
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "memgraph_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import memgraph_tpu_torch
names = [m.name for m in pkgutil.walk_packages(memgraph_tpu_torch.__path__,
                                               "memgraph_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert {"memgraph_tpu_torch.main", "memgraph_tpu_torch.server.bolt",
        "memgraph_tpu_torch.server.packstream",
        "memgraph_tpu_torch.server.client", "memgraph_tpu_torch.auth.auth",
        "memgraph_tpu_torch.auth.module", "memgraph_tpu_torch.dbms.dbms",
        "memgraph_tpu_torch.utils.license",
        "memgraph_tpu_torch.utils.tls"} <= set(names)
from memgraph_tpu_torch.query.interpreter import Interpreter, InterpreterContext
from memgraph_tpu_torch.storage import InMemoryStorage
it = Interpreter(InterpreterContext(InMemoryStorage(), device="cpu"))
assert it.execute("CREATE (n:A {x: 1}) RETURN n.x")[1] == [[1]]
assert not [m for m in sys.modules if m.split(".")[0] in
            ("jax", "memgraph_tpu")]
print(len(names))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) > 100
