"""The port's procedure counterparts (memgraph_tpu_torch/procedures/
graph_algorithms.py) against the JAX package's Cypher ``CALL``s on one
storage.

Each test builds a fresh storage (so the JAX package's warm pool seeds
nothing: its first call is cold, as every port call is), runs the
procedure through the JAX package's interpreter, then the port's
counterpart on a snapshot of the same storage, read through the storage
adapter of tests/test_torch_snapshot.py, and compares the records gid by
gid.  Tolerances are those the other port tests hold each algorithm to:
PageRank and katz rtol 1e-5 (atol 1e-9), PPR 1e-6 of the largest rank,
HITS atol 1e-6, betweenness 1e-5 of the largest score; labels,
components, degrees, levels, distances and k-hop sets exactly.
"""

import numpy as np
import pytest

from memgraph_tpu.query.interpreter import Interpreter, InterpreterContext
from memgraph_tpu.storage import InMemoryStorage
from memgraph_tpu_torch.ops.csr import GraphCache
from memgraph_tpu_torch.procedures import graph_algorithms as P
from memgraph_tpu_torch.utils.metrics import global_metrics

from test_torch_snapshot import StorageSource

import torch

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

N, E = 150, 700


@pytest.fixture
def db():
    """A fresh storage with N vertices and E edges (some parallel, some
    self-loops), a float ``weight`` on every edge; its interpreter
    context and a port snapshot cache of its own."""
    storage = InMemoryStorage()
    rng = np.random.default_rng(21)
    acc = storage.access()
    et = storage.edge_type_mapper.name_to_id("E")
    wprop = storage.property_mapper.name_to_id("weight")
    vs = [acc.create_vertex() for _ in range(N)]
    src = rng.integers(0, N, E)
    dst = (rng.random(E) ** 2 * N).astype(np.int64)
    for s, d, w in zip(src, dst, rng.uniform(0.5, 1.5, E)):
        acc.create_edge(vs[s], vs[d], et).set_property(wprop, float(w))
    acc.commit()
    return storage, InterpreterContext(storage), GraphCache(), \
        [v.gid for v in vs]


def cypher(ictx, query, params=None) -> dict:
    """gid -> the record's other columns, of a Cypher query whose first
    column is id(node)."""
    _, rows, _ = Interpreter(ictx).execute(query, params)
    return {int(r[0]): tuple(r[1:]) for r in rows}


def port(storage, cache, fn, *args, **kw) -> dict:
    acc = storage.access()
    try:
        out = fn(StorageSource(acc), *args, cache=cache, device="cpu", **kw)
    finally:
        acc.abort()
    gids = out.pop("node_gids")
    assert gids.dtype == np.int64
    assert all(isinstance(v, np.ndarray) and len(v) == len(gids)
               for v in out.values())
    return {int(g): tuple(v[i] for v in out.values())
            for i, g in enumerate(gids)}


def compare(want: dict, got: dict, rtol=0.0, atol=0.0):
    assert set(want) == set(got) and want
    for gid, row in want.items():
        np.testing.assert_allclose(np.asarray(got[gid], dtype=np.float64),
                                   np.asarray(row, dtype=np.float64),
                                   rtol=rtol, atol=atol)


@pytest.mark.parametrize("weighted", [False, True])
def test_pagerank_get(db, weighted):
    storage, ictx, cache, _ = db
    args = "50, 0.85, 1e-7, 'weight'" if weighted else ""
    want = cypher(ictx, f"CALL pagerank.get({args}) YIELD node, rank "
                        "RETURN id(node), rank")
    kw = dict(max_iterations=50, stop_epsilon=1e-7,
              weight_property="weight") if weighted else {}
    compare(want, port(storage, cache, P.pagerank_get, **kw), 1e-5, 1e-9)


def test_pagerank_personalized(db):
    storage, ictx, cache, gids = db
    seeds = [gids[3], gids[40], gids[99]]
    want = cypher(ictx, "MATCH (n) WHERE id(n) IN $ids WITH collect(n) AS s "
                        "CALL pagerank.personalized(s) YIELD node, rank "
                        "RETURN id(node), rank", {"ids": seeds})
    got = port(storage, cache, P.pagerank_personalized, seeds)
    top = max(abs(r[0]) for r in want.values())
    compare(want, got, atol=1e-6 * top)


def test_katz_centrality_get(db):
    storage, ictx, cache, _ = db
    want = cypher(ictx, "CALL katz_centrality.get(0.05, 1e-6) "
                        "YIELD node, rank RETURN id(node), rank")
    got = port(storage, cache, P.katz_centrality_get, 0.05, 1e-6)
    compare(want, got, 1e-5, 1e-9)


@pytest.mark.parametrize("weighted", [False, True])
def test_community_detection_get(db, weighted):
    storage, ictx, cache, _ = db
    args = "30, 'weight'" if weighted else ""
    want = cypher(ictx, f"CALL community_detection.get({args}) "
                        "YIELD node, community_id "
                        "RETURN id(node), community_id")
    got = port(storage, cache, P.community_detection_get,
               weight_property="weight" if weighted else None)
    compare(want, got)
    assert min(r[0] for r in got.values()) == 1


def test_weakly_connected_components_get(db):
    storage, ictx, cache, _ = db
    want = cypher(ictx, "CALL weakly_connected_components.get() "
                        "YIELD node, component_id "
                        "RETURN id(node), component_id")
    compare(want, port(storage, cache, P.weakly_connected_components_get))


def test_strongly_connected_components_get(db):
    storage, ictx, cache, _ = db
    want = cypher(ictx, "CALL strongly_connected_components.get() "
                        "YIELD node, component_id "
                        "RETURN id(node), component_id")
    compare(want, port(storage, cache, P.strongly_connected_components_get))


@pytest.mark.parametrize("kind", ["in", "OUT", "undirected"])
def test_degree_centrality_get(db, kind):
    storage, ictx, cache, _ = db
    want = cypher(ictx, "CALL degree_centrality.get($t) YIELD node, degree "
                        "RETURN id(node), degree", {"t": kind})
    compare(want, port(storage, cache, P.degree_centrality_get, kind))


def test_hits_get(db):
    storage, ictx, cache, _ = db
    want = cypher(ictx, "CALL hits.get() YIELD node, hub, authority "
                        "RETURN id(node), hub, authority")
    compare(want, port(storage, cache, P.hits_get), atol=1e-6)


@pytest.mark.parametrize("args,kw", [
    ("", {}), ("false, true", {"directed": False}),
    ("true, false, 20", {"normalized": False, "samples": 20})])
def test_betweenness_centrality_get(db, args, kw):
    storage, ictx, cache, _ = db
    want = cypher(ictx, f"CALL betweenness_centrality.get({args}) "
                        "YIELD node, betweenness_centrality "
                        "RETURN id(node), betweenness_centrality")
    got = port(storage, cache, P.betweenness_centrality_get, **kw)
    top = max(abs(r[0]) for r in want.values())
    compare(want, got, atol=1e-5 * top)


@pytest.mark.parametrize("directed", [True, False])
def test_bfs_get(db, directed):
    storage, ictx, cache, gids = db
    want = cypher(ictx, "MATCH (s) WHERE id(s) = $g CALL bfs.get(s, $d) "
                        "YIELD node, level RETURN id(node), level",
                  {"g": gids[5], "d": directed})
    compare(want, port(storage, cache, P.bfs_get, gids[5], directed))


def test_sssp_get(db):
    storage, ictx, cache, gids = db
    want = cypher(ictx, "MATCH (s) WHERE id(s) = $g CALL sssp.get(s) "
                        "YIELD node, distance RETURN id(node), distance",
                  {"g": gids[7]})
    compare(want, port(storage, cache, P.sssp_get, gids[7]))


@pytest.mark.parametrize("directed", [False, True])
def test_graph_util_khop(db, directed):
    storage, ictx, cache, gids = db
    seeds = [gids[1], gids[60]]
    want = cypher(ictx, "MATCH (n) WHERE id(n) IN $ids WITH collect(n) AS s "
                        "CALL graph_util.khop(s, 2, $d) YIELD node "
                        "RETURN id(node)", {"ids": seeds, "d": directed})
    got = port(storage, cache, P.graph_util_khop, seeds, 2, directed)
    assert set(want) == set(got) and len(got) > 2


def test_an_empty_storage_yields_nothing():
    storage = InMemoryStorage()
    cache = GraphCache()
    for name, fn in P.PROCEDURES.items():
        args = {"pagerank.personalized": ([0],), "bfs.get": (0,),
                "sssp.get": (0,), "graph_util.khop": ([0], 1)}.get(name, ())
        acc = storage.access()
        out = fn(StorageSource(acc), *args, cache=cache, device="cpu")
        acc.abort()
        assert all(len(v) == 0 for v in out.values()), name


def test_unknown_sources_yield_nothing(db):
    storage, _, cache, gids = db
    missing = max(gids) + 1000
    assert port(storage, cache, P.bfs_get, missing) == {}
    assert port(storage, cache, P.sssp_get, missing) == {}
    assert port(storage, cache, P.pagerank_personalized, [missing]) == {}
    assert port(storage, cache, P.graph_util_khop, [missing], 2) == {}


def test_one_snapshot_serves_the_calls(db):
    """Calls at one version share the cache's snapshot; a commit gives
    the next one by the delta export."""
    storage, _, cache, gids = db
    fallbacks = global_metrics.value("delta.fallback_rebuild_total")
    acc = storage.access()
    src = StorageSource(acc)
    P.degree_centrality_get(src, cache=cache, device="cpu")
    P.hits_get(src, cache=cache, device="cpu")
    acc.abort()
    assert cache.counters["export.full"] == 1
    acc = storage.access()
    acc.create_edge(acc.find_vertex(gids[0]), acc.find_vertex(gids[1]),
                    storage.edge_type_mapper.name_to_id("E"))
    acc.commit()
    port(storage, cache, P.pagerank_get)
    assert cache.counters == {"export.full": 1, "export.delta": 1}
    assert global_metrics.value("delta.fallback_rebuild_total") == fallbacks
