"""The port's edge deltas and warm pool (memgraph_tpu_torch/ops/delta.py)
against the JAX package's (memgraph_tpu/ops/delta.py), and the four
procedures that consult the pool against the JAX interpreter's CALLs on
one storage over a call, a repeat, an adds-only commit and a removal
commit.

Deltas, diffs and splices are compared exactly (arrays and dtypes, the
refreshed snapshot array for array).  The pool's verdicts (hit, warm
seed, cold) and its cold-start count follow the JAX pool's on the same
sequence (tests/test_delta.py's scenarios).  The procedures' records are
held to tests/test_torch_procedures.py's tolerances (PageRank and katz
rtol 1e-5, atol 1e-9; labels and components exactly); a repeat returns
the stored bytes, and a warm start's iterations differ from the JAX
package's by at most 1.
"""

import numpy as np
import pytest

from memgraph_tpu.observability.metrics import global_metrics
from memgraph_tpu.ops import csr as jcsr
from memgraph_tpu.ops import delta as JD
from memgraph_tpu_torch.ops import csr as tcsr
from memgraph_tpu_torch.ops import delta as TD
from memgraph_tpu_torch.procedures import graph_algorithms as P
from memgraph_tpu_torch.utils.metrics import global_metrics as tmetrics
from memgraph_tpu.storage.storage import EdgeAccessor

from test_torch_procedures import compare, cypher, db  # noqa: F401
from test_torch_snapshot import StorageSource, _storage, assert_same_snapshot

import torch

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)


def _coo(seed=0, n=120, e=900):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, e).astype(np.int32),
            rng.integers(0, n, e).astype(np.int32),
            rng.choice(np.float32([0.5, 1.0, 2.0]), e)), n


def _edit(coo, seed, adds=25, removes=20):
    """A successor COO: ``removes`` edges dropped, ``adds`` appended, and
    the changed dense indices (the endpoints of both)."""
    (src, dst, w), rng = coo, np.random.default_rng(seed)
    n = int(max(src.max(), dst.max())) + 1
    drop = rng.choice(len(src), removes, replace=False)
    keep = np.ones(len(src), dtype=bool)
    keep[drop] = False
    a_s = rng.integers(0, n, adds).astype(np.int32)
    a_d = rng.integers(0, n, adds).astype(np.int32)
    a_w = rng.choice(np.float32([0.5, 1.0, 3.0]), adds)
    new = (np.concatenate([src[keep], a_s]), np.concatenate([dst[keep], a_d]),
           np.concatenate([w[keep], a_w]))
    changed = np.unique(np.concatenate([src[drop], dst[drop], a_s, a_d]))
    return new, changed


def _same_delta(a, b):
    for f in ("add_src", "add_dst", "add_w", "rem_src", "rem_dst", "rem_w"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert (a.base_version, a.version) == (b.base_version, b.version)


@pytest.mark.parametrize("seed", [0, 4])
def test_diffs_equal_the_reference(seed):
    prev, n = _coo(seed)
    cur, changed = _edit(prev, seed + 1)
    want = JD.diff_changed_coo(prev, cur, changed, n, 3, 5)
    got = TD.diff_changed_coo(prev, cur, changed, n, 3, 5)
    _same_delta(want, got)
    assert not got.adds_only and got.n_delta == want.n_delta
    bitmap = np.zeros(n, dtype=bool)
    bitmap[changed] = True
    for a, b in zip(JD.incident_edges(*cur, bitmap),
                    TD.incident_edges(*cur, bitmap)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    inc = TD.incident_edges(*cur, bitmap)
    _same_delta(JD.diff_incident(prev, changed, inc[0], inc[1], None, n, 3, 5),
                TD.diff_incident(prev, changed, inc[0], inc[1], None, n, 3, 5))
    for a, b in zip(JD.multiset_edge_diff(prev, cur),
                    TD.multiset_edge_diff(prev, cur)):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    for a, b in zip(JD.multiset_edge_diff(([], [], []), ([], [], [])),
                    TD.multiset_edge_diff(([], [], []), ([], [], []))):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and len(x) == len(y) == 0


def test_edge_delta_methods_equal_the_reference():
    prev, n = _coo(2)
    cur, changed = _edit(prev, 3)
    want = JD.diff_changed_coo(prev, cur, changed, n, 1, 2)
    got = TD.diff_changed_coo(prev, cur, changed, n, 1, 2)
    _same_delta(want.doubled(), got.doubled())
    assert np.array_equal(want.wsum_adjust(n), got.wsum_adjust(n))
    assert np.array_equal(want.touched_nodes(), got.touched_nodes())
    arrays = got.to_arrays()
    assert arrays.keys() == want.to_arrays().keys()
    _same_delta(TD.EdgeDelta.from_arrays(1, 2, arrays), got)
    del arrays["delta_rem_w"]
    assert TD.EdgeDelta.from_arrays(1, 2, arrays) is None
    _same_delta(JD.empty_delta(4, 4), TD.empty_delta(4, 4))
    assert TD.empty_delta(4, 4).adds_only
    adds = TD.diff_changed_coo(prev, (np.concatenate([prev[0], [1]]),
                                      np.concatenate([prev[1], [2]]),
                                      np.concatenate([prev[2], [1.0]])),
                               [1, 2], n, 0, 1)
    assert adds.adds_only and adds.n_delta == 1


@pytest.mark.parametrize("seed", [1, 6])
def test_splice_and_refresh_equal_the_reference(seed):
    prev, n = _coo(seed)
    cur, changed = _edit(prev, seed + 10)
    delta = TD.diff_changed_coo(prev, cur, changed, n, 0, 1)
    jdelta = JD.diff_changed_coo(prev, cur, changed, n, 0, 1)
    want = JD.splice_coo(prev, jdelta, n)
    got = TD.splice_coo(prev, delta, n)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    gids = np.arange(n, dtype=np.int64) * 3 + 7
    jprev = jcsr.from_coo(*prev, n_nodes=n, node_gids=gids)
    tprev = tcsr.from_coo(*prev, n_nodes=n, node_gids=gids)
    jg = JD.refresh_device_graph(jprev, jdelta)
    tg = TD.refresh_device_graph(tprev, delta, device="cpu")
    assert tg.device.type == "cpu"
    assert_same_snapshot(jg, tg)


def test_a_removal_that_does_not_match_gives_none():
    prev, n = _coo(3)
    z = np.zeros(0, np.int64)
    bad = TD.EdgeDelta(0, 1, z, z, np.zeros(0, np.float32),
                       np.array([int(prev[0][0])]),
                       np.array([int(prev[1][0])]),
                       np.array([prev[2][0] + 0.25], np.float32))
    jbad = JD.EdgeDelta(0, 1, z, z, np.zeros(0, np.float32), bad.rem_src,
                        bad.rem_dst, bad.rem_w)
    assert JD.splice_coo(prev, jbad, n) is None
    assert TD.splice_coo(prev, bad, n) is None
    assert TD.refresh_device_graph(tcsr.from_coo(*prev, n_nodes=n), bad,
                                   device="cpu") is None


def test_warm_start_contract_equals_the_reference():
    assert TD.WARM_START_POLICY == JD.WARM_START_POLICY
    for algo in (*JD.WARM_START_POLICY, "other"):
        for ok in (True, False):
            assert TD.warm_start_decision(algo, ok) == \
                JD.warm_start_decision(algo, ok)


def _metric(name):
    return dict((n, v) for n, _k, v
                in global_metrics.snapshot()).get(name, 0.0)


class Twin:
    """One storage, its JAX pool and the port's, each fed its package's
    export of the storage at the newest version."""

    def __init__(self):
        self.storage, self.vs, self.et = _storage(n=60, e=240, seed=2)
        self.jpool, self.tpool = JD.LocalWarmPool(), TD.LocalWarmPool()

    def exports(self):
        acc = self.storage.access()
        src = StorageSource(acc)
        jg = jcsr.export_csr(acc, to_device=False)
        tg = tcsr.export_csr(src, to_device=False)
        return acc, src, jg, tg, acc.topology_snapshot

    def verdicts(self, algo, key=("k",)):
        """(JAX (hit, seed), port (hit, seed)) at the newest version, and
        the cold starts each pool counted.  Read-only accessors commit:
        an abort bumps the storage's version."""
        acc, src, jg, tg, v = self.exports()
        cold = (_metric("delta.cold_start_total"),
                tmetrics.value("delta.cold_start_total"))
        try:
            want = self.jpool.prepare(self.storage, jg, v, algo, key)
            got = self.tpool.prepare(src, tg, v, algo, key)
        finally:
            acc.commit()
        return want, got, (_metric("delta.cold_start_total") - cold[0],
                           tmetrics.value("delta.cold_start_total") - cold[1])

    def store(self, algo, x, key=("k",)):
        acc, src, jg, tg, v = self.exports()
        try:
            self.jpool.store(self.storage, jg, v, algo, key, x)
            self.tpool.store(src, tg, v, algo, key, x, iters=3)
        finally:
            acc.commit()

    def add_edge(self):
        acc = self.storage.access()
        acc.create_edge(self.vs[0], self.vs[1], self.et)
        acc.commit()

    def remove_edge(self):
        acc = self.storage.access()
        for ve in list(self.storage._edges.values()):
            ea = EdgeAccessor(ve, acc)
            if ea.is_visible():
                acc.delete_edge(ea)
                break
        acc.commit()


def _kind(verdict):
    hit, seed = verdict
    return ("hit" if hit is not None else "seed" if seed is not None
            else "none"), (hit if hit is not None else seed)


def _same_verdict(want, got):
    (wk, wx), (gk, gx) = _kind(want), _kind(got)
    assert wk == gk
    if wx is not None:
        assert np.array_equal(wx, gx)
    return gk


@pytest.mark.parametrize("algo", ["pagerank", "wcc"])
def test_pool_verdicts_follow_the_reference(algo):
    twin = Twin()
    x = np.arange(60, dtype=np.float32)
    want, got, cold = twin.verdicts(algo)
    assert _same_verdict(want, got) == "none" and cold == (0, 0)
    twin.store(algo, x)
    want, got, _ = twin.verdicts(algo)
    assert _same_verdict(want, got) == "hit"
    sol = twin.tpool.solution(twin.storage, algo)
    assert sol.iters == 3 and np.array_equal(sol.x, x)
    # the pool keeps its own read-only copy
    assert not sol.x.flags.writeable and x.flags.writeable
    want, got, _ = twin.verdicts(algo, key=("other",))
    assert _same_verdict(want, got) == "none"
    twin.add_edge()
    want, got, cold = twin.verdicts(algo)
    assert _same_verdict(want, got) == "seed" and cold == (0, 0)
    twin.store(algo, x + 1)          # the pool's snapshot moves
    twin.remove_edge()
    want, got, cold = twin.verdicts(algo)
    if algo == "wcc":
        assert _same_verdict(want, got) == "none" and cold == (1, 1)
        # the cold start dropped the solution: no verdict again
        want, got, cold = twin.verdicts(algo)
        assert _same_verdict(want, got) == "none" and cold == (0, 0)
    else:
        assert _same_verdict(want, got) == "seed" and cold == (0, 0)


def test_pool_folds_a_removal_into_the_kept_solutions():
    """A store at a new version after a removal marks the other kept
    solutions monotone-unsafe, as the JAX pool does."""
    twin = Twin()
    twin.store("wcc", np.arange(60))
    twin.remove_edge()
    twin.store("pagerank", np.ones(60, np.float32))
    twin.add_edge()
    want, got, cold = twin.verdicts("wcc")
    assert _same_verdict(want, got) == "none" and cold == (1, 1)


def test_pool_cold_on_a_wrapped_log():
    twin = Twin()
    twin.store("labelprop", np.arange(60))
    for _ in range(1100):
        twin.storage._bump_topology({twin.vs[0].gid})
    want, got, cold = twin.verdicts("labelprop")
    assert _same_verdict(want, got) == "none" and cold == (1, 1)
    twin.store("pagerank", np.ones(60, np.float32))
    for _ in range(1100):
        twin.storage._bump_topology({twin.vs[0].gid})
    want, got, cold = twin.verdicts("pagerank")
    assert _same_verdict(want, got) == "seed" and cold == (0, 0)


def test_pool_no_seed_when_the_node_set_moved():
    twin = Twin()
    twin.store("pagerank", np.ones(60, np.float32))
    acc = twin.storage.access()
    acc.create_vertex()
    acc.commit()
    want, got, cold = twin.verdicts("pagerank")
    assert _same_verdict(want, got) == "none" and cold == (0, 0)
    twin.tpool.clear()
    assert twin.tpool.solution(twin.storage, "pagerank") is None


# --- the procedures over commits -------------------------------------------

CALLS = {
    "pagerank": ("CALL pagerank.get() YIELD node, rank "
                 "RETURN id(node), rank", P.pagerank_get, (), 1e-5, 1e-9),
    "katz": ("CALL katz_centrality.get(0.05, 1e-6) YIELD node, rank "
             "RETURN id(node), rank", P.katz_centrality_get, (0.05, 1e-6),
             1e-5, 1e-9),
    "labelprop": ("CALL community_detection.get() YIELD node, community_id "
                  "RETURN id(node), community_id", P.community_detection_get,
                  (), 0.0, 0.0),
    "wcc": ("CALL weakly_connected_components.get() YIELD node, "
            "component_id RETURN id(node), component_id",
            P.weakly_connected_components_get, (), 0.0, 0.0),
}


def _port(storage, cache, pool, fn, *args):
    acc = storage.access()
    try:
        out = fn(StorageSource(acc), *args, cache=cache, pool=pool,
                 device="cpu")
    finally:
        acc.commit()           # an abort would bump the version
    return out


def _by_gid(out):
    gids = out["node_gids"]
    col = [v for k, v in out.items() if k != "node_gids"][0]
    return {int(g): (col[i],) for i, g in enumerate(gids)}


@pytest.mark.parametrize("algo", list(CALLS))
def test_procedures_over_commits_follow_the_reference(db, algo,
                                                      monkeypatch):
    storage, ictx, cache, gids = db
    query, fn, args, rtol, atol = CALLS[algo]
    pool = TD.LocalWarmPool()
    jax_warm = []
    real = JD.record_warm_start
    monkeypatch.setattr(JD, "record_warm_start", lambda a, i: (
        jax_warm.append((a, int(i))), real(a, i)))
    et = storage.edge_type_mapper.name_to_id("E")
    warm0 = tmetrics.value("delta.warm_start_total")
    cold0 = tmetrics.value("delta.cold_start_total")

    def step():
        want = cypher(ictx, query)
        got = _port(storage, cache, pool, fn, *args)
        compare(want, _by_gid(got), rtol, atol)
        return got

    first = step()
    again = step()
    # a repeat on an unchanged graph: the stored bytes, kept read-only
    for k in first:
        assert first[k].tobytes() == again[k].tobytes()
    assert tmetrics.value("delta.warm_start_total") == warm0
    assert not pool.solution(storage, algo).x.flags.writeable
    col = [k for k in first if k != "node_gids"][0]
    first[col][:] = 0           # the cold answer is its caller's own copy
    assert step()[col].tobytes() == again[col].tobytes()

    acc = storage.access()
    for a, b in ((3, 9), (40, 2), (77, 120), (5, 5)):
        acc.create_edge(acc.find_vertex(gids[a]), acc.find_vertex(gids[b]),
                        et)
    acc.commit()
    step()
    assert tmetrics.value("delta.warm_start_total") == warm0 + 1
    assert len(jax_warm) == 1
    assert abs(pool.solution(storage, algo).iters - jax_warm[-1][1]) <= 1

    acc = storage.access()
    removed = 0
    for ve in list(storage._edges.values()):
        ea = EdgeAccessor(ve, acc)
        if ea.is_visible() and removed < 3:
            acc.delete_edge(ea)
            removed += 1
    acc.commit()
    cold = _metric("delta.cold_start_total")
    step()
    monotone = TD.WARM_START_POLICY[algo] == "adds_only"
    assert tmetrics.value("delta.cold_start_total") == cold0 + int(monotone)
    assert _metric("delta.cold_start_total") - cold == int(monotone)
    assert tmetrics.value("delta.warm_start_total") \
        == warm0 + 2 - int(monotone)
    assert len(jax_warm) == 2 - int(monotone)
    if not monotone:
        assert abs(pool.solution(storage, algo).iters
                   - jax_warm[-1][1]) <= 1
