"""The port's resident generations and the server's deltas
(memgraph_tpu_torch/ops/delta.py: ``incident_from_storage``,
``compile_edge_delta``, ``ResidentGraph``, ``ResidentRegistry``) against
the JAX package's on the same storage and the same deltas.

The storage is read through tests/test_torch_snapshot.py's
``StorageSource``.  Arrays are compared exactly (the same numpy in both
packages), counters by how far each package's moved.  PageRank on a
refreshed resident snapshot is held to the JAX package's within rtol
1e-5, atol 1e-9 (tests/test_torch_delta.py's bound: the MXU plan forced
at test scale in both packages, the two differing only in the order of
f32 sums), and its plan must come by a ``DeltaPlan``: ``build_plan`` is
stubbed to raise there, as tests/test_torch_delta.py does.
"""

import numpy as np
import pytest
import torch

from memgraph_tpu.observability.metrics import global_metrics as jmetrics
from memgraph_tpu.ops import csr as jcsr
from memgraph_tpu.ops import delta as JD
from memgraph_tpu.ops import pagerank as jpr
from memgraph_tpu.storage import InMemoryStorage
from memgraph_tpu.storage.storage import ChangeLogUnknowable as JUnknowable
from memgraph_tpu_torch.ops import csr as tcsr
from memgraph_tpu_torch.ops import delta as TD
from memgraph_tpu_torch.ops import pagerank as tpr
from memgraph_tpu_torch.ops import spmv_mxu as T
from memgraph_tpu_torch.utils.metrics import global_metrics as tmetrics
from test_torch_snapshot import StorageSource

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-9
ITERS = 25


def _jmetric(name):
    return dict((n, v) for n, _k, v in jmetrics.snapshot()).get(name, 0.0)


def _moved(names):
    """{name: (JAX value, port value)} now, to diff later."""
    return {n: (_jmetric(n), tmetrics.value(n)) for n in names}


def _assert_moved_alike(before, by=None):
    for name, (j0, t0) in before.items():
        dj, dt = _jmetric(name) - j0, tmetrics.value(name) - t0
        assert dj == dt, f"{name}: JAX moved {dj}, the port {dt}"
        if by is not None:
            assert dt == by.get(name, dt), f"{name} moved {dt}"


def _coo(seed=0, n=200, e=1500):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, e).astype(np.int64),
            rng.integers(0, n, e).astype(np.int64),
            rng.random(e).astype(np.float32))


def _graphs(src, dst, w, n):
    return (jcsr.from_coo(src, dst, w, n_nodes=n),
            tcsr.from_coo(src, dst, w, n_nodes=n))


def _adds(seed, n, k, base_version, version):
    rng = np.random.default_rng(seed)
    z = np.zeros(0, np.int64)
    zf = np.zeros(0, np.float32)
    s, d = (rng.integers(0, n, k).astype(np.int64) for _ in range(2))
    w = np.ones(k, np.float32)
    return (JD.EdgeDelta(base_version, version, s, d, w, z, z, zf),
            TD.EdgeDelta(base_version, version, s, d, w, z, z, zf))


def _removal(src, dst, w, idx, base_version, version):
    z = np.zeros(0, np.int64)
    zf = np.zeros(0, np.float32)
    args = (z, z, zf, src[idx], dst[idx], w[idx])
    return (JD.EdgeDelta(base_version, version, *args),
            TD.EdgeDelta(base_version, version, *args))


def _gens(src, dst, w, n, version=0, key="k"):
    jg, tg = _graphs(src, dst, w, n)
    return JD.ResidentGraph(key, version, jg), TD.ResidentGraph(key, version,
                                                                tg)


def _same_coo(jgen, tgen):
    for a, b in zip(jgen.coo, tgen.coo):
        assert np.array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# the server's deltas from a storage
# ---------------------------------------------------------------------------


def _storage(n=40):
    storage = InMemoryStorage()
    acc = storage.access()
    vs = [acc.create_vertex() for _ in range(n)]
    et = storage.edge_type_mapper.name_to_id("E")
    wp = storage.property_mapper.name_to_id("w")
    rng = np.random.default_rng(0)
    for _ in range(n * 4):
        a, b = rng.integers(0, n, 2)
        e = acc.create_edge(vs[a], vs[b], et)
        e.set_property(wp, float(rng.random()))
    acc.commit()
    return storage, et, wp


def _export(storage):
    acc = storage.access()
    jg = jcsr.export_csr(acc, to_device=False)
    tg = tcsr.export_csr(StorageSource(acc), to_device=False)
    return acc, jg, tg, acc.topology_snapshot


@pytest.mark.parametrize("weighted", [False, True])
def test_incident_from_storage_matches_jax(weighted):
    storage, et, wp = _storage()
    acc, jg, tg, _ = _export(storage)
    gids = list(storage._vertices)
    changed = [gids[3], gids[7], gids[8], gids[21]]
    got = TD.incident_from_storage(StorageSource(acc), tg.gid_to_idx,
                                   changed, "w" if weighted else None)
    want = JD.incident_from_storage(acc, jg.gid_to_idx, changed,
                                    wp if weighted else None)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    acc.commit()
    # a deleted changed vertex: the node set moved, both say None
    acc = storage.access()
    acc.delete_vertex(acc.find_vertex(gids[5]), detach=True)
    acc.commit()
    acc = storage.access()
    assert JD.incident_from_storage(acc, jg.gid_to_idx, [gids[5]]) is None
    assert TD.incident_from_storage(StorageSource(acc), tg.gid_to_idx,
                                    [gids[5]]) is None
    acc.commit()


def test_compile_edge_delta_typed_verdicts():
    storage, et, _ = _storage()
    acc1, jg1, tg1, v1 = _export(storage)
    acc1.commit()
    acc = storage.access()
    gids = list(storage._vertices)
    acc.create_edge(acc.find_vertex(gids[4]), acc.find_vertex(gids[5]), et)
    acc.commit()
    acc2, jg2, tg2, v2 = _export(storage)
    src = StorageSource(acc2)
    got = TD.compile_edge_delta(src, tg1, tg2, v1, v2)
    want = JD.compile_edge_delta(storage, jg1, jg2, v1, v2)
    assert isinstance(got, TD.EdgeDelta) and got.adds_only
    for name in ("add_src", "add_dst", "add_w", "rem_src", "rem_dst",
                 "rem_w"):
        assert np.array_equal(getattr(got, name), getattr(want, name))
    assert TD.compile_edge_delta(src, tg2, tg2, v2, v2).n_delta == 0
    # a node-set change: None in both
    tg_small = tcsr.from_coo(np.array([0]), np.array([1]), n_nodes=3)
    jg_small = jcsr.from_coo(np.array([0]), np.array([1]), n_nodes=3)
    assert TD.compile_edge_delta(src, tg_small, tg2, v1, v2) is None
    assert JD.compile_edge_delta(storage, jg_small, jg2, v1, v2) is None
    acc2.commit()
    # the log wrapped: the typed verdict, falsy
    for _ in range(1100):
        storage._bump_topology({0})
    acc3, jg3, tg3, v3 = _export(storage)
    got = TD.compile_edge_delta(StorageSource(acc3), tg2, tg3, v2, v3)
    assert isinstance(got, tcsr.ChangeLogUnknowable) and not got
    assert isinstance(JD.compile_edge_delta(storage, jg2, jg3, v2, v3),
                      JUnknowable)
    acc3.commit()


# ---------------------------------------------------------------------------
# ResidentGraph and ResidentRegistry
# ---------------------------------------------------------------------------


def test_registry_lru_and_capacity():
    regs = (JD.ResidentRegistry(capacity=2), TD.ResidentRegistry(capacity=2))
    for i in range(3):
        src, dst, w = _coo(seed=20 + i, n=50, e=200)
        for reg, gen in zip(regs, _gens(src, dst, w, 50, key=f"k{i}")):
            reg.put(gen)
            if i == 1:
                assert reg.get("k0") is not None   # k0 now the newest
    for reg in regs:
        assert len(reg) == 2
        assert reg.get("k1") is None               # the least recent
        assert reg.get("k0") is not None and reg.get("k2") is not None
    assert tmetrics.value("delta.resident_generations") == 2.0
    assert regs[1].peek("k2").graph_key == "k2"


def test_empty_delta_bumps_version_and_rebuilds_nothing():
    src, dst, w = _coo(seed=16)
    before = _moved(["delta.applied_total"])
    for gen, D in zip(_gens(src, dst, w, 200, version=3), (JD, TD)):
        gen.note_solution("pagerank", ("p",), np.zeros(200))
        snapshot = gen.graph
        assert gen.apply(D.empty_delta(3, 7))
        assert gen.version == 7
        assert gen.graph is snapshot               # no rebuild
        assert gen.solutions["pagerank"].monotone_ok
        assert gen.cached_result("pagerank", ("p",)) is None  # moved
    _assert_moved_alike(before, {"delta.applied_total": 1})


def test_accumulated_deltas_compact(monkeypatch):
    monkeypatch.setattr(JD, "DELTA_COMPACT_FRACTION", 0.01)
    monkeypatch.setattr(TD, "DELTA_COMPACT_FRACTION", 0.01)
    n = 200
    src, dst, w = _coo(seed=17, n=n)
    jgen, tgen = _gens(src, dst, w, n)
    before = _moved(["delta.compacted_total", "delta.applied_total"])
    for i in range(4):
        jd, td = _adds(18 + i, n, 8, i, i + 1)
        assert jgen.apply(jd) and tgen.apply(td)
        _same_coo(jgen, tgen)
        assert (jgen.delta_edges, jgen.base_edges, jgen.version) == \
            (tgen.delta_edges, tgen.base_edges, tgen.version)
    _assert_moved_alike(before)
    assert tmetrics.value("delta.compacted_total") \
        > before["delta.compacted_total"][1]
    assert tgen.delta_edges < 16                   # the count restarted
    # an oversized delta compacts outright, spliced all the same
    monkeypatch.setattr(JD, "DELTA_MAX_FRACTION", 0.0)
    monkeypatch.setattr(TD, "DELTA_MAX_FRACTION", 0.0)
    jd, td = _adds(30, n, 1100, 4, 5)
    before = _moved(["delta.compacted_total"])
    assert jgen.apply(jd) and tgen.apply(td)
    _same_coo(jgen, tgen)
    _assert_moved_alike(before, {"delta.compacted_total": 1})
    assert np.array_equal(tgen.graph.host_coo[0], jgen.graph.host_coo[0])


def test_removal_matching_nothing_returns_false():
    src, dst, w = _coo(seed=19)
    jgen, tgen = _gens(src, dst, w, 200)
    # an edge the graph does not hold (its weight differs)
    jd, td = _removal(src, dst, w + 7.0, [0], 0, 1)
    before = _moved(["delta.fallback_rebuild_total"])
    assert jgen.apply(jd) is False and tgen.apply(td) is False
    _assert_moved_alike(before, {"delta.fallback_rebuild_total": 1})
    assert tgen.version == 0
    _same_coo(jgen, tgen)


def test_monotone_gate_makes_a_loud_cold_start(caplog):
    src, dst, w = _coo(seed=15)
    jgen, tgen = _gens(src, dst, w, 200)
    for gen in (jgen, tgen):
        gen.note_solution("wcc", ("wcc",), np.arange(200))
        gen.note_solution("pagerank", ("p",), np.full(200, 1 / 200))
    # an adds-only delta keeps the WCC seed
    for gen, d in zip((jgen, tgen), _adds(5, 200, 10, 0, 1)):
        assert gen.apply(d)
        x0, reason = gen.warm_x0("wcc", ("wcc",))
        assert x0 is not None and reason == "monotone_adds_only"
    before = _moved(["delta.cold_start_total"])
    for gen, d in zip((jgen, tgen), _removal(src, dst, w, [1, 2], 1, 2)):
        assert gen.apply(d)
    with caplog.at_level("WARNING"):
        for gen in (jgen, tgen):
            x0, reason = gen.warm_x0("wcc", ("wcc",))
            assert x0 is None and reason == "monotone_unsafe"
            assert "wcc" not in gen.solutions       # the seed dropped
            x0, reason = gen.warm_x0("pagerank", ("p",))
            assert x0 is not None and reason == "contraction"
    _assert_moved_alike(before, {"delta.cold_start_total": 1})
    assert any("COLD start for wcc" in r.getMessage()
               for r in caplog.records
               if r.name == "memgraph_tpu_torch.ops.delta")


def test_cached_result_is_the_stored_solution():
    src, dst, w = _coo(seed=21)
    _, tgen = _gens(src, dst, w, 200)
    x = np.arange(200, dtype=np.float32)
    tgen.note_solution("pagerank", ("p",), x, err=0.5, iters=3,
                       max_iterations=10)
    hit = tgen.cached_result("pagerank", ("p",), 10)
    assert hit.x is x and (hit.err, hit.iters) == (0.5, 3)
    assert tgen.cached_result("pagerank", ("p",), 11) is None
    assert tgen.cached_result("pagerank", ("q",), 10) is None


# ---------------------------------------------------------------------------
# the refresh lineage: a resident snapshot's plan by a DeltaPlan
# ---------------------------------------------------------------------------


@pytest.fixture
def force_mxu(monkeypatch):
    monkeypatch.setattr(tpr, "MXU_MIN_EDGES", 0)
    monkeypatch.setattr(jpr, "MXU_MIN_EDGES", 1)
    monkeypatch.setenv("MEMGRAPH_TPU_FORCE_MXU", "1")
    monkeypatch.delenv("MEMGRAPH_TPU_MESH_DEVICES", raising=False)
    monkeypatch.delenv("MEMGRAPH_TPU_ROUTE_DTYPE", raising=False)


def test_resident_snapshot_refreshes_by_delta_plan(force_mxu, monkeypatch):
    """A generation moved by deltas rebuilds its snapshot with
    ``_delta_ctx = (the snapshot with the full plan, changed gids since
    it)``, and PageRank on it builds no plan; past
    ``DELTA_RECOMPACT_FRACTION`` it replans in full, counted, and that
    snapshot anchors the next refresh."""
    n = 1000
    src, dst, w = _coo(seed=3, n=n, e=6000)
    jgen, tgen = _gens(src, dst, w, n)
    base = tgen.graph
    tpr.pagerank(base, max_iterations=ITERS, tol=-1.0, device="cpu")
    assert base._mxu_base_self
    real, armed = T.build_plan, []

    def build_plan(*args, **kw):
        if armed:
            raise AssertionError("build_plan ran for a delta snapshot")
        return real(*args, **kw)

    monkeypatch.setattr(T, "build_plan", build_plan)
    armed.append(1)
    for step in range(2):
        jd, td = _adds(40 + step, n, 30, step, step + 1)
        assert jgen.apply(jd) and tgen.apply(td)
        g = tgen.graph
        anchor, changed = g._delta_ctx
        touched = set()
        for k in range(step + 1):
            touched |= set(_adds(40 + k, n, 30, k, k + 1)[1]
                           .touched_nodes().tolist())
        assert anchor is base and set(changed) == touched
        deltas = T.plan_counts["build_delta_plan"]
        got, _, _ = tpr.pagerank(g, max_iterations=ITERS, tol=-1.0,
                                 device="cpu")
        assert T.plan_counts["build_delta_plan"] == deltas + 1
        assert g._mxu_state["delta"] is not None
        want, _, _ = jpr.pagerank(jgen.graph, max_iterations=ITERS,
                                  tol=-1.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
    # past the recompact fraction: an honest full replan, counted
    armed.clear()
    builds = T.plan_counts["build_plan"]
    jd, td = _adds(50, n, 1100, 2, 3)
    assert jgen.apply(jd) and tgen.apply(td)
    g = tgen.graph
    got, _, _ = tpr.pagerank(g, max_iterations=ITERS, tol=-1.0,
                             device="cpu")
    assert T.plan_counts["build_plan"] == builds + 1
    assert g._mxu_base_self
    want, _, _ = jpr.pagerank(jgen.graph, max_iterations=ITERS, tol=-1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    # that snapshot anchors the next refresh
    jd, td = _adds(51, n, 10, 3, 4)
    assert tgen.apply(td)
    assert tgen.graph._delta_ctx[0] is g
    assert isinstance(tgen.graph.row_ptr, np.ndarray)   # stays host-side
    assert not isinstance(got, np.ndarray) and got.device == torch.device(
        "cpu")
