"""The graph-algorithm procedures through the port's Cypher engine against
the JAX package's interpreter on the CPU.

The same graph (2,000 vertices, 10,000 edges with a float ``weight``,
parallel edges and self-loops among them) is built in a storage of each
package; each ``CALL`` runs through the JAX package's ``Interpreter`` and
through the port's (``device="cpu"``), and the records are compared gid by
gid.  Tolerances are tests/test_torch_procedures.py's: PageRank and katz
rtol 1e-5 (atol 1e-9), PPR 1e-6 of the largest rank, HITS atol 1e-6,
betweenness 1e-5 of the largest score; labels, components, degrees,
levels, distances and k-hop sets exactly.  Every alias of a procedure
answers as its name does.

Also here: a commit followed by a ``CALL`` refreshes the snapshot by
delta and warm-starts PageRank (``delta.warm_start_total``).
"""

import numpy as np
import pytest
import torch

from memgraph_tpu.query import interpreter as jinterp
from memgraph_tpu.storage import InMemoryStorage as JStorage
from memgraph_tpu_torch.ops.csr import GLOBAL_GRAPH_CACHE
from memgraph_tpu_torch.query import interpreter as tinterp
from memgraph_tpu_torch.storage import InMemoryStorage as TStorage
from memgraph_tpu_torch.utils.metrics import global_metrics

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

N, E = 2000, 10000


def build(storage):
    rng = np.random.default_rng(21)
    acc = storage.access()
    et = storage.edge_type_mapper.name_to_id("E")
    lb = storage.label_mapper.name_to_id("N")
    wprop = storage.property_mapper.name_to_id("weight")
    vs = []
    for _ in range(N):
        v = acc.create_vertex()
        v.add_label(lb)
        vs.append(v)
    src = rng.integers(0, N, E)
    dst = (rng.random(E) ** 2 * N).astype(np.int64)
    for s, d, w in zip(src, dst, rng.uniform(0.5, 1.5, E)):
        acc.create_edge(vs[s], vs[d], et).set_property(wprop, float(w))
    acc.commit()
    return [v.gid for v in vs]


@pytest.fixture(scope="module")
def db():
    js, ts = JStorage(), TStorage()
    gids = build(js)
    assert build(ts) == gids
    j = jinterp.Interpreter(jinterp.InterpreterContext(js))
    t = tinterp.Interpreter(tinterp.InterpreterContext(ts, device="cpu"))
    return j, t, gids


def records(interp, query, params=None) -> dict:
    """gid -> the record's other columns, of a query whose first column
    is id(node)."""
    _, rows, _ = interp.execute(query, params)
    out = {int(r[0]): tuple(r[1:]) for r in rows}
    assert len(out) == len(rows)
    return out


def compare(want: dict, got: dict, rtol=0.0, atol=0.0):
    assert set(want) == set(got) and want
    for gid, row in want.items():
        np.testing.assert_allclose(np.asarray(got[gid], dtype=np.float64),
                                   np.asarray(row, dtype=np.float64),
                                   rtol=rtol, atol=atol)


def both(db, query, params=None):
    j, t, _ = db
    return records(j, query, params), records(t, query, params)


@pytest.mark.parametrize("name", ["pagerank.get", "pagerank_tpu.get",
                                  "pagerank_online.get"])
@pytest.mark.parametrize("args", ["", "50, 0.85, 1e-7, 'weight'"])
def test_pagerank_get(db, name, args):
    want, got = both(db, f"CALL {name}({args}) YIELD node, rank "
                         "RETURN id(node), rank")
    compare(want, got, 1e-5, 1e-9)


def test_pagerank_personalized(db):
    gids = db[2]
    want, got = both(db, "MATCH (n) WHERE id(n) IN $ids WITH collect(n) AS s "
                         "CALL pagerank.personalized(s) YIELD node, rank "
                         "RETURN id(node), rank",
                     {"ids": [gids[3], gids[40], gids[999]]})
    top = max(abs(r[0]) for r in want.values())
    compare(want, got, atol=1e-6 * top)


@pytest.mark.parametrize("name", ["katz_centrality.get",
                                  "katz_centrality_tpu.get",
                                  "katz_centrality_online.get"])
def test_katz_centrality_get(db, name):
    want, got = both(db, f"CALL {name}(0.05, 1e-6) YIELD node, rank "
                         "RETURN id(node), rank")
    compare(want, got, 1e-5, 1e-9)


@pytest.mark.parametrize("name,args", [
    ("community_detection.get", ""),
    ("community_detection.get", "30, 'weight'"),
    ("label_propagation.get", ""),
    ("community_detection_tpu.get", "10")])
def test_community_detection_get(db, name, args):
    want, got = both(db, f"CALL {name}({args}) YIELD node, community_id "
                         "RETURN id(node), community_id")
    compare(want, got)


@pytest.mark.parametrize("name", ["weakly_connected_components.get",
                                  "wcc.get", "connectivity.get",
                                  "strongly_connected_components.get"])
def test_components(db, name):
    want, got = both(db, f"CALL {name}() YIELD node, component_id "
                         "RETURN id(node), component_id")
    compare(want, got)


@pytest.mark.parametrize("kind", ["in", "OUT", "undirected"])
def test_degree_centrality_get(db, kind):
    want, got = both(db, "CALL degree_centrality.get($t) YIELD node, degree "
                         "RETURN id(node), degree", {"t": kind})
    compare(want, got)


def test_hits_get(db):
    want, got = both(db, "CALL hits.get() YIELD node, hub, authority "
                         "RETURN id(node), hub, authority")
    compare(want, got, atol=1e-6)


@pytest.mark.parametrize("args", ["false, true, 40", "true, false, 40"])
def test_betweenness_centrality_get(db, args):
    want, got = both(db, f"CALL betweenness_centrality.get({args}) "
                         "YIELD node, betweenness_centrality "
                         "RETURN id(node), betweenness_centrality")
    top = max(abs(r[0]) for r in want.values())
    compare(want, got, atol=1e-5 * top)


@pytest.mark.parametrize("directed", [True, False])
def test_bfs_get(db, directed):
    want, got = both(db, "MATCH (s) WHERE id(s) = $g CALL bfs.get(s, $d) "
                         "YIELD node, level RETURN id(node), level",
                     {"g": db[2][5], "d": directed})
    compare(want, got)


def test_sssp_get(db):
    want, got = both(db, "MATCH (s) WHERE id(s) = $g CALL sssp.get(s) "
                         "YIELD node, distance RETURN id(node), distance",
                     {"g": db[2][7]})
    compare(want, got)


@pytest.mark.parametrize("directed", [False, True])
def test_graph_util_khop(db, directed):
    gids = db[2]
    want, got = both(db, "MATCH (n) WHERE id(n) IN $ids "
                         "WITH collect(n) AS s "
                         "CALL graph_util.khop(s, 2, $d) YIELD node "
                         "RETURN id(node)",
                     {"ids": [gids[1], gids[60]], "d": directed})
    assert set(want) == set(got) and len(got) > 2


def test_a_procedure_feeds_the_rest_of_the_query(db):
    """YIELD into WITH / ORDER BY / aggregation: the rows are the
    storage's vertices, their properties readable."""
    q = ("CALL pagerank.get() YIELD node, rank "
         "WITH node, rank ORDER BY rank DESC, id(node) LIMIT 10 "
         "RETURN id(node), labels(node), rank")
    want, got = both(db, q)
    assert list(want) == list(got)
    for gid in want:
        assert want[gid][0] == got[gid][0] == ["N"]
        np.testing.assert_allclose(got[gid][1], want[gid][1], rtol=1e-5,
                                   atol=1e-9)


def test_procedures_are_listed_in_explain(db):
    j, t, _ = db
    q = "EXPLAIN CALL wcc.get() YIELD node, component_id RETURN count(node)"
    assert t.execute(q)[1] == j.execute(q)[1]


def test_a_commit_then_a_call_warm_starts_from_a_delta_snapshot():
    """Commit, then CALL: the snapshot is refreshed by delta and PageRank
    starts from the previous answer."""
    ts = TStorage()
    gids = build(ts)
    t = tinterp.Interpreter(tinterp.InterpreterContext(ts, device="cpu"))
    q = "CALL pagerank.get() YIELD node, rank RETURN id(node), rank"
    first = records(t, q)
    warm0 = global_metrics.value("delta.warm_start_total")
    delta0 = GLOBAL_GRAPH_CACHE.counters["export.delta"]
    pairs = [[gids[i], gids[(i * 7 + 3) % N]] for i in range(0, 600, 3)]
    t.execute("UNWIND $p AS p MATCH (a), (b) WHERE id(a) = p[0] AND "
              "id(b) = p[1] CREATE (a)-[:E {weight: 1.0}]->(b)", {"p": pairs})
    second = records(t, q)
    assert GLOBAL_GRAPH_CACHE.counters["export.delta"] == delta0 + 1
    assert global_metrics.value("delta.warm_start_total") == warm0 + 1
    assert set(first) == set(second) and first != second
    # the warm answer is the cold answer on the new graph, within the
    # stopping rule
    js = JStorage()
    build(js)
    j = jinterp.Interpreter(jinterp.InterpreterContext(js))
    j.execute("UNWIND $p AS p MATCH (a), (b) WHERE id(a) = p[0] AND "
              "id(b) = p[1] CREATE (a)-[:E {weight: 1.0}]->(b)", {"p": pairs})
    want = records(j, q)
    err = sum(abs(second[g][0] - want[g][0]) for g in want)
    assert err < 1e-4
