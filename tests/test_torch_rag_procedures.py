"""The port's ``graphrag.retrieve`` (procedures/graphrag.py),
``igraphalg.pagerank`` and ``igraphalg.shortest_path_length``
(procedures/igraph_module.py) and ``union_find.connected``
(procedures/combinatorial_modules.py) against the JAX interpreter's
CALLs on one storage.

Tolerances: ``graphrag.retrieve``'s scores 1e-6 of the largest and its
seed similarities 1e-6 (tests/test_torch_ml_procedures.py's
``ppr_search`` bound), the same records; ``igraphalg.pagerank`` rtol
1e-5, atol 1e-9 (tests/test_torch_procedures.py's PageRank bound);
shortest path lengths rtol 1e-6 (float32 sums in another order), inf
where the JAX package has it; connectivity exactly.
"""

import math

import numpy as np
import pytest

from memgraph_tpu.query.interpreter import Interpreter
from memgraph_tpu_torch.ops.csr import GraphCache
from memgraph_tpu_torch.procedures import ProcedureError
from memgraph_tpu_torch.procedures import combinatorial_modules as CM
from memgraph_tpu_torch.procedures import graphrag as GR
from memgraph_tpu_torch.procedures import igraph_module as IG
from memgraph_tpu_torch.procedures import vector_search as VS

from test_torch_ml_procedures import _build
from test_torch_procedures import compare, cypher, db, port  # noqa: F401
from test_torch_snapshot import StorageSource

import torch

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)


def rows(ictx, query, params=None) -> list:
    return Interpreter(ictx).execute(query, params)[1]


def call(storage, fn, *args, **kw) -> dict:
    acc = storage.access()
    try:
        return fn(StorageSource(acc), *args, device="cpu", **kw)
    finally:
        acc.commit()


@pytest.fixture
def emb_db():
    return _build()


RETRIEVE = ("CALL graphrag.retrieve('emb', $q, $k, $h, $n) "
            "YIELD node, score, seed_similarity "
            "RETURN id(node), score, seed_similarity")


@pytest.mark.parametrize("k,hops,limit", [(3, 2, 200), (5, 1, 200),
                                          (4, 2, 6)])
def test_graphrag_retrieve(emb_db, k, hops, limit):
    storage, ictx, _ = emb_db
    q = [1.0, 0.5, -0.5, 0.0, 0.2, 0.9, -1.1, 0.4]
    want = rows(ictx, RETRIEVE, {"q": q, "k": k, "h": hops, "n": limit})
    got = call(storage, GR.retrieve, "emb", q, k, hops, limit,
               cache=GraphCache(), index_cache=VS.IndexCache())
    assert len(want) > 3 and len(got["node_gids"]) == len(want)
    top = max(r[1] for r in want)
    if limit >= len(want):
        by_gid = {int(g): (s, t) for g, s, t in zip(
            got["node_gids"], got["score"], got["seed_similarity"])}
        assert set(by_gid) == {int(r[0]) for r in want}
        for gid, score, seed_sim in want:
            assert abs(by_gid[gid][0] - score) <= 1e-6 * top
            assert abs(by_gid[gid][1] - seed_sim) <= 1e-6
    else:
        np.testing.assert_allclose(got["score"], [r[1] for r in want],
                                   atol=1e-6 * top)
    assert bool((np.diff(got["score"]) <= 0).all())
    assert bool((got["score"] > 0).all())


def test_graphrag_retrieve_without_the_property_yields_nothing(emb_db):
    storage, ictx, _ = emb_db
    q = [1.0] * 8
    assert rows(ictx, RETRIEVE.replace("'emb'", "'nope'"),
                {"q": q, "k": 3, "h": 2, "n": 5}) == []
    got = call(storage, GR.retrieve, "nope", q, 3, cache=GraphCache(),
               index_cache=VS.IndexCache())
    assert all(len(v) == 0 for v in got.values())


@pytest.mark.parametrize("args,kw", [
    ("", {}), ("0.7", {"damping": 0.7}),
    ("0.85, 'weight'", {"weights": "weight"}),
    ("0.85, null, false", {"directed": False}),
    ("0.85, 'weight', false, 'arpack'", {"weights": "weight",
                                         "directed": False,
                                         "implementation": "arpack"})])
def test_igraph_pagerank(db, args, kw):
    storage, ictx, cache, _ = db
    want = cypher(ictx, f"CALL igraphalg.pagerank({args}) YIELD node, rank "
                        "RETURN id(node), rank")
    compare(want, port(storage, cache, IG.pagerank_get, **kw), 1e-5, 1e-9)


def test_igraph_pagerank_refuses_an_unknown_implementation(db):
    storage, ictx, cache, _ = db
    with pytest.raises(Exception) as want:
        cypher(ictx, "CALL igraphalg.pagerank(0.85, null, true, 'x') "
                     "YIELD node, rank RETURN id(node), rank")
    with pytest.raises(ProcedureError) as got:
        port(storage, cache, IG.pagerank_get, implementation="x")
    assert str(got.value) in str(want.value)


SPL = ("MATCH (a), (b) WHERE id(a) = $a AND id(b) = $b "
       "CALL igraphalg.shortest_path_length(a, b, $w, $d) YIELD length "
       "RETURN length")


@pytest.mark.parametrize("weights", [None, "weight"])
@pytest.mark.parametrize("directed", [True, False])
def test_igraph_shortest_path_length(db, weights, directed):
    storage, ictx, cache, gids = db
    rng = np.random.default_rng(8)
    pairs = [(gids[int(a)], gids[int(b)])
             for a, b in rng.integers(0, len(gids), (8, 2))]
    pairs.append((gids[-1], gids[0]))
    lengths = []
    for a, b in pairs:
        (want,), = rows(ictx, SPL, {"a": a, "b": b, "w": weights,
                                    "d": directed})
        got = call(storage, IG.shortest_path_length, a, b, weights,
                   directed, cache=cache)["length"]
        assert got.shape == (1,)
        if math.isinf(want):
            assert math.isinf(got[0]) and got[0] > 0
        else:
            np.testing.assert_allclose(got[0], want, rtol=1e-6)
        lengths.append(want)
    assert any(math.isfinite(x) for x in lengths)


def test_igraph_shortest_path_length_reaches_nothing_past_the_graph(db):
    storage, ictx, cache, gids = db
    acc = storage.access()
    lone = acc.create_vertex().gid
    acc.commit()
    (want,), = rows(ictx, SPL, {"a": gids[0], "b": lone, "w": None,
                                "d": True})
    got = call(storage, IG.shortest_path_length, gids[0], lone, cache=cache)
    assert math.isinf(want) and math.isinf(got["length"][0])
    with pytest.raises(ProcedureError, match="not part of the current"):
        call(storage, IG.shortest_path_length, gids[0], lone + 999,
             cache=cache)


UF = ("MATCH (a) WHERE id(a) IN $l1 WITH collect(a) AS l1 "
      "MATCH (b) WHERE id(b) IN $l2 WITH l1, collect(b) AS l2 "
      "CALL union_find.connected(l1, l2, $m, $u) "
      "YIELD node1, node2, connected "
      "RETURN id(node1), id(node2), connected")


def _uf(ictx, storage, cache, l1, l2, mode, update):
    want = rows(ictx, UF, {"l1": l1, "l2": l2, "m": mode, "u": update})
    # the lists in the order the query collected them
    lhs = list(dict.fromkeys(int(r[0]) for r in want))
    rhs = (list(dict.fromkeys(int(r[1]) for r in want))
           if mode == "cartesian" else [int(r[1]) for r in want])
    if mode == "pairwise":
        lhs = [int(r[0]) for r in want]
    got = call(storage, CM.union_find_connected, lhs, rhs, mode, update,
               cache=cache)
    assert [(int(a), int(b), bool(c)) for a, b, c in want] == list(zip(
        got["node1_gids"].tolist(), got["node2_gids"].tolist(),
        got["connected"].tolist()))
    return got


def _components_db(storage, gids):
    """Two isolated vertices more, one of them then joined to the graph."""
    acc = storage.access()
    extra = [acc.create_vertex().gid for _ in range(2)]
    acc.commit()
    return extra


@pytest.mark.parametrize("mode", ["pairwise", "cartesian"])
def test_union_find_connected(db, mode):
    storage, ictx, cache, gids = db
    extra = _components_db(storage, gids)
    l1 = [gids[0], gids[3], extra[0], gids[9]]
    l2 = [gids[7], extra[1], gids[5], extra[0]]
    got = _uf(ictx, storage, cache, l1, l2, mode, True)
    assert got["connected"].any() and not got["connected"].all()


def test_union_find_update_false_serves_the_stored_labels(db):
    storage, ictx, cache, gids = db
    extra = _components_db(storage, gids)
    l1, l2 = [gids[0], gids[1]], [extra[0], gids[2]]
    first = _uf(ictx, storage, cache, l1, l2, "cartesian", True)
    acc = storage.access()
    acc.create_edge(acc.find_vertex(gids[0]), acc.find_vertex(extra[0]),
                    storage.edge_type_mapper.name_to_id("E"))
    acc.commit()
    stale = _uf(ictx, storage, cache, l1, l2, "cartesian", False)
    assert np.array_equal(stale["connected"], first["connected"])
    fresh = _uf(ictx, storage, cache, l1, l2, "cartesian", True)
    assert fresh["connected"].sum() > first["connected"].sum()


@pytest.mark.parametrize("l1,l2,mode", [
    ([0, 1], [2], "pairwise"), ([0], [1], "diagonal")])
def test_union_find_errors_are_the_references(db, l1, l2, mode):
    storage, ictx, cache, gids = db
    l1, l2 = [gids[i] for i in l1], [gids[i] for i in l2]
    with pytest.raises(Exception) as want:
        rows(ictx, UF, {"l1": l1, "l2": l2, "m": mode, "u": True})
    with pytest.raises(ProcedureError) as got:
        call(storage, CM.union_find_connected, l1, l2, mode, cache=cache)
    assert str(got.value) in str(want.value)


def test_union_find_takes_single_gids(db):
    storage, _, cache, gids = db
    got = call(storage, CM.union_find_connected, gids[0], gids[0],
               cache=cache)
    assert got["connected"].tolist() == [True]
    got = call(storage, CM.union_find_connected, gids[0], -5, cache=cache)
    assert got["connected"].tolist() == [False]
