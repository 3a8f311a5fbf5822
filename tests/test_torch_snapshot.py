"""The port's storage snapshots (``export_csr``, ``export_csr_delta``,
``GraphCache``) against the JAX package's on one ``InMemoryStorage``.

The port reads the storage through a source (memgraph_tpu_torch/ops/
csr.py); ``StorageSource`` below is the adapter of a JAX-package storage
accessor (its graph and its vertex properties), kept here because the
port may not import that package.  The scenarios replay
tests/test_csr_export.py, tests/test_csr_delta_export.py and
tests/test_plan_delta_e2e.py.  Snapshots are compared exactly: node
gids, host COO, CSR and CSC arrays, the path taken (delta or full, as
counted), the ``_delta_ctx`` anchor's version and changed set.  PageRank
on a refreshed snapshot is held to the JAX package's within rtol 1e-5,
atol 1e-9 (tests/test_torch_delta.py's bound: the two differ only in the
order of f32 sums), the MXU plan forced at test scale in both packages.
``CooSource`` (memgraph_tpu_torch/northstar.py) is held against the
adapter on the same commits.
"""

import numpy as np
import pytest

from memgraph_tpu.ops import csr as jcsr
from memgraph_tpu.ops import pagerank as jpr
from memgraph_tpu.storage import InMemoryStorage, StorageConfig, StorageMode
from memgraph_tpu.storage.common import View
from memgraph_tpu.storage.storage import ChangeLogUnknowable as JUnknowable
from memgraph_tpu.storage.storage import EdgeAccessor, VertexAccessor
from memgraph_tpu_torch.northstar import CooSource
from memgraph_tpu_torch.ops import csr as tcsr
from memgraph_tpu_torch.ops import pagerank as tpr
from memgraph_tpu_torch.utils.metrics import global_metrics as tmetrics

import torch

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-9
ITERS = 25
FIELDS = ("row_ptr", "col_idx", "src_idx", "weights", "csc_src", "csc_dst",
          "csc_weights", "out_degree")


class StorageSource:
    """The port's snapshot source over a JAX-package storage accessor: the
    accessor's view read as memgraph_tpu/ops/csr.py reads it."""

    def __init__(self, accessor):
        self.accessor = accessor
        self.storage = accessor.storage

    @property
    def version(self):
        v = getattr(self.accessor, "topology_snapshot", None)
        return self.storage.topology_version if v is None else v

    def changes_between(self, v_from, v_to):
        got = self.storage.changes_between(v_from, v_to)
        if isinstance(got, JUnknowable):
            return tcsr.ChangeLogUnknowable(got.reason,
                                            got.oldest_logged_version)
        return got

    def _prop(self, wp):
        if isinstance(wp, str):
            return self.storage.property_mapper.maybe_name_to_id(wp)
        return wp

    def vertices(self, label_filter=None):
        acc = self.accessor
        out = []
        for vertex in list(self.storage._vertices.values()):
            if vertex.delta is None:
                if vertex.deleted or (label_filter is not None
                                      and label_filter not in vertex.labels):
                    continue
            else:
                va = VertexAccessor(vertex, acc)
                if not va.is_visible(View.OLD) or (
                        label_filter is not None
                        and not va.has_label(label_filter, View.OLD)):
                    continue
            out.append(vertex.gid)
        return out

    def edges(self, weight_property=None, edge_type_filter=None):
        wp = self._prop(weight_property)
        src, dst, ws = [], [], []
        for edge in list(self.storage._edges.values()):
            if edge.delta is None:
                if edge.deleted:
                    continue
                props = edge.properties
            else:
                ea = EdgeAccessor(edge, self.accessor)
                if not ea.is_visible(View.OLD):
                    continue
                props = ea.properties(View.OLD)
            if edge_type_filter is not None \
                    and edge.edge_type not in edge_type_filter:
                continue
            src.append(edge.from_vertex.gid)
            dst.append(edge.to_vertex.gid)
            ws.append(props.get(wp) if props else None)
        return src, dst, (ws if wp is not None else None)

    def incident(self, gid, weight_property=None, edge_type_filter=None,
                 label_filter=None):
        acc = self.accessor
        vertex = self.storage._vertices.get(gid)
        if vertex is None:
            return None
        va = VertexAccessor(vertex, acc)
        visible = va.is_visible(View.OLD)
        if label_filter is not None and visible:
            visible = va.has_label(label_filter, View.OLD)
        if not visible:
            return None
        wp = self._prop(weight_property)
        # the accessor's raw state: no session filter
        st = acc._vertex_state(vertex, View.OLD)
        out = []
        for entries, far in ((st.out_edges, "to_vertex"),
                             (st.in_edges, "from_vertex")):
            gids, ws = [], []
            for (etype, _other, edge) in entries:
                if edge_type_filter is not None \
                        and etype not in edge_type_filter:
                    continue
                ea = EdgeAccessor(edge, acc)
                if not ea.is_visible(View.OLD):
                    continue
                gids.append(getattr(edge, far).gid)
                ws.append(ea.properties(View.OLD).get(wp))
            out += [gids, ws if wp is not None else None]
        return tuple(out)

    def vertex_records(self, gids):
        storage = self.storage
        out = []
        for gid in gids:
            vertex = storage._vertices.get(int(gid))
            va = None if vertex is None else VertexAccessor(vertex,
                                                            self.accessor)
            if va is None or not va.is_visible(View.OLD):
                out.append(None)
                continue
            labels = [storage.label_mapper.id_to_name(lb)
                      for lb in va.labels(View.OLD)]
            props = {storage.property_mapper.id_to_name(pid): val
                     for pid, val in va.properties(View.OLD).items()}
            out.append((labels, props))
        return out

    def vertex_property(self, name, gids):
        pid = self._prop(name)
        if pid is None:
            return None
        out = []
        for gid in gids:
            vertex = self.storage._vertices.get(int(gid))
            va = None if vertex is None else VertexAccessor(vertex,
                                                            self.accessor)
            out.append(va.get_property(pid, View.OLD)
                       if va is not None and va.is_visible(View.OLD)
                       else None)
        return out


def _host(a):
    return a.numpy() if hasattr(a, "numpy") and not isinstance(
        a, np.ndarray) else np.asarray(a)


def assert_same_snapshot(jg, tg):
    assert np.array_equal(np.asarray(jg.node_gids), tg.node_gids)
    assert (jg.n_nodes, jg.n_edges, jg.n_pad, jg.e_pad) == \
        (tg.n_nodes, tg.n_edges, tg.n_pad, tg.e_pad)
    for f in FIELDS:
        a, b = np.asarray(getattr(jg, f)), _host(getattr(tg, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for a, b in zip(jg.host_coo, tg.host_coo):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _storage(n=400, e=2500, seed=5, labels=False, two_types=False):
    storage = InMemoryStorage(StorageConfig(
        storage_mode=StorageMode.IN_MEMORY_TRANSACTIONAL))
    rng = np.random.default_rng(seed)
    acc = storage.access()
    types = [storage.edge_type_mapper.name_to_id(t) for t in ("E", "F")]
    label = storage.label_mapper.name_to_id("L")
    vs = [acc.create_vertex() for _ in range(n)]
    if labels:
        for v in vs[::3]:
            v.add_label(label)
    edges = []
    for i, (s, d) in enumerate(zip(rng.integers(0, n, e),
                                   rng.integers(0, n, e))):
        et = types[i % 2] if two_types else types[0]
        edges.append(acc.create_edge(vs[s], vs[d], et))
    acc.commit()
    return storage, vs, types[0]


def _mutate(storage, vs, et, seed, adds=30, removes=10, into=None):
    """Add ``adds`` edges (into ``into`` when given), remove ``removes``."""
    rng = np.random.default_rng(seed)
    acc = storage.access()
    for _ in range(adds):
        d = into if into is not None else int(rng.integers(0, len(vs)))
        acc.create_edge(vs[int(rng.integers(0, len(vs)))], vs[d], et)
    removed = 0
    for ve in list(storage._edges.values()):
        if removed >= removes:
            break
        ea = EdgeAccessor(ve, acc)
        if ea.is_visible():
            acc.delete_edge(ea)
            removed += 1
    acc.commit()


def _jax_fallbacks():
    from memgraph_tpu.observability.metrics import global_metrics
    return dict((n, v) for n, _, v in global_metrics.snapshot()).get(
        "delta.fallback_rebuild_total", 0.0)


def _port_fallbacks():
    return tmetrics.value("delta.fallback_rebuild_total")


class Twin:
    """The JAX GraphCache and the port's on one storage, each snapshot
    taken from one accessor; the JAX cache's paths counted by wrapping
    its module's export functions."""

    def __init__(self, storage, monkeypatch):
        self.storage = storage
        self.jcache = jcsr.GraphCache()
        self.tcache = tcsr.GraphCache()
        self.jpaths = {"export.full": 0, "export.delta": 0}
        self.jsnaps, self.tsnaps = {}, {}
        real_full, real_delta = jcsr.export_csr, jcsr.export_csr_delta

        def full(*a, **k):
            self.jpaths["export.full"] += 1
            return real_full(*a, **k)

        def delta(*a, **k):
            g = real_delta(*a, **k)
            if g is not None:
                self.jpaths["export.delta"] += 1
            return g

        monkeypatch.setattr(jcsr, "export_csr", full)
        monkeypatch.setattr(jcsr, "export_csr_delta", delta)

    def get(self, ranks=False, **kw):
        acc = self.storage.access()
        try:
            version = StorageSource(acc).version
            jg = self.jcache.get(acc, **kw)
            tg = self.tcache.get(StorageSource(acc), device="cpu", **kw)
        finally:
            acc.abort()
        self.jsnaps[id(jg)] = version
        self.tsnaps[id(tg)] = version
        assert_same_snapshot(jg, tg)
        assert self.tcache.counters["export.full"] == \
            self.jpaths["export.full"]
        assert self.tcache.counters["export.delta"] == \
            self.jpaths["export.delta"]
        jctx = getattr(jg, "_delta_ctx", None)
        tctx = getattr(tg, "_delta_ctx", None)
        assert (jctx is None) == (tctx is None)
        if jctx is not None:
            assert self.jsnaps[id(jctx[0])] == self.tsnaps[id(tctx[0])]
            assert jctx[1] == tctx[1]
        if ranks:
            jr, _, jit = jpr.pagerank(jg, max_iterations=ITERS, tol=-1.0)
            tr, _, tit = tpr.pagerank(tg, max_iterations=ITERS, tol=-1.0)
            assert int(jit) == tit == ITERS
            np.testing.assert_allclose(tr.numpy(), np.asarray(jr),
                                       rtol=RTOL, atol=ATOL)
        return jg, tg


@pytest.fixture
def force_mxu(monkeypatch):
    """The MXU plan at test scale in both packages (tests/
    test_plan_delta_e2e.py, tests/test_torch_delta.py)."""
    monkeypatch.setattr(tpr, "MXU_MIN_EDGES", 0)
    monkeypatch.setattr(jpr, "MXU_MIN_EDGES", 1)
    monkeypatch.setenv("MEMGRAPH_TPU_FORCE_MXU", "1")
    monkeypatch.delenv("MEMGRAPH_TPU_MESH_DEVICES", raising=False)
    monkeypatch.delenv("MEMGRAPH_TPU_ROUTE_DTYPE", raising=False)


# ---------------------------------------------------------------------------
# full exports (tests/test_csr_export.py)
# ---------------------------------------------------------------------------

def _both_exports(acc, **kw):
    jg = jcsr.export_csr(acc, to_device=False, **kw)
    tg = tcsr.export_csr(StorageSource(acc), to_device=False, **kw)
    return jg, tg


def test_export_basic_and_uncommitted_objects():
    storage, vs, et = _storage(n=50, e=200)
    writer = storage.access()
    v = writer.create_vertex()
    writer.create_edge(writer.find_vertex(vs[0].gid), v, et)
    reader = storage.access()
    jg, tg = _both_exports(reader)
    reader.abort()
    writer.abort()
    assert tg.n_nodes == 50 and tg.n_edges == 200
    assert_same_snapshot(jg, tg)


def test_export_leaves_deleted_vertices_out():
    storage, vs, et = _storage(n=60, e=300)
    d = storage.access()
    d.delete_vertex(d.find_vertex(vs[7].gid), detach=True)
    d.commit()
    acc = storage.access()
    jg, tg = _both_exports(acc)
    acc.abort()
    assert tg.n_nodes == 59 and vs[7].gid not in tg.gid_to_idx
    assert_same_snapshot(jg, tg)


@pytest.mark.parametrize("value", [2.5, 3, "heavy", True, None])
def test_export_weight_property(value):
    storage, vs, et = _storage(n=40, e=150)
    wprop = storage.property_mapper.name_to_id("w")
    acc = storage.access()
    for ve in list(storage._edges.values())[::4]:
        EdgeAccessor(ve, acc).set_property(wprop, value)
    acc.commit()
    acc = storage.access()
    jg, tg = _both_exports(acc, weight_property=wprop)
    acc.abort()
    assert_same_snapshot(jg, tg)


def test_export_label_and_edge_type_filters():
    storage, vs, et = _storage(n=120, e=700, labels=True, two_types=True)
    label = storage.label_mapper.name_to_id("L")
    f_type = storage.edge_type_mapper.name_to_id("F")
    acc = storage.access()
    for kw in ({"label_filter": label}, {"edge_type_filter": {f_type}},
               {"label_filter": label, "edge_type_filter": {et}}):
        jg, tg = _both_exports(acc, **kw)
        assert_same_snapshot(jg, tg)
    acc.abort()
    assert 0 < tg.n_nodes < 120


def test_export_of_an_empty_storage():
    storage = InMemoryStorage()
    acc = storage.access()
    jg, tg = _both_exports(acc)
    acc.abort()
    assert tg.n_nodes == tg.n_edges == 0
    assert_same_snapshot(jg, tg)


# ---------------------------------------------------------------------------
# delta exports (tests/test_csr_delta_export.py)
# ---------------------------------------------------------------------------

def _prev_and_changed(storage, mutate, **kw):
    v0 = storage.topology_version
    acc = storage.access()
    jprev = jcsr.export_csr(acc, to_device=False, **kw)
    tprev = tcsr.export_csr(StorageSource(acc), to_device=False, **kw)
    acc.abort()
    mutate()
    acc = storage.access()
    src = StorageSource(acc)
    return jprev, tprev, src.changes_between(v0, src.version), acc


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_delta_export_equals_the_full_export_and_the_jax_delta(seed):
    storage, vs, et = _storage()
    jprev, tprev, changed, acc = _prev_and_changed(
        storage, lambda: _mutate(storage, vs, et, seed))
    assert changed
    src = StorageSource(acc)
    got = tcsr.export_csr_delta(tprev, src, changed, to_device=False)
    want = tcsr.export_csr(src, to_device=False)
    jgot = jcsr.export_csr_delta(jprev, acc, changed, to_device=False)
    acc.abort()
    assert got is not None
    assert_same_snapshot(jgot, got)
    for f in FIELDS + ("col_ptr",):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


def test_delta_export_weighted():
    storage, vs, et = _storage()
    wprop = storage.property_mapper.name_to_id("w")
    acc = storage.access()
    for ve in list(storage._edges.values())[:100]:
        EdgeAccessor(ve, acc).set_property(wprop, 2.5)
    acc.commit()

    def set_one():
        acc = storage.access()
        EdgeAccessor(next(iter(storage._edges.values())),
                     acc).set_property(wprop, 9.0)
        acc.commit()

    jprev, tprev, changed, acc = _prev_and_changed(
        storage, set_one, weight_property=wprop)
    src = StorageSource(acc)
    got = tcsr.export_csr_delta(tprev, src, changed, weight_property=wprop,
                                to_device=False)
    jgot = jcsr.export_csr_delta(jprev, acc, changed, weight_property=wprop,
                                 to_device=False)
    acc.abort()
    assert_same_snapshot(jgot, got)
    assert 9.0 in got.weights


def test_delta_export_bails_on_a_new_vertex():
    storage, vs, et = _storage()

    def add_vertex():
        acc = storage.access()
        acc.create_edge(acc.create_vertex(), vs[0], et)
        acc.commit()

    jprev, tprev, changed, acc = _prev_and_changed(storage, add_vertex)
    src = StorageSource(acc)
    assert tcsr.export_csr_delta(tprev, src, changed) is None
    assert jcsr.export_csr_delta(jprev, acc, changed) is None
    acc.abort()


def test_delta_export_bails_on_a_deleted_vertex():
    storage, vs, et = _storage()

    def delete_vertex():
        acc = storage.access()
        acc.delete_vertex(acc.find_vertex(vs[3].gid), detach=True)
        acc.commit()

    jprev, tprev, changed, acc = _prev_and_changed(storage, delete_vertex)
    src = StorageSource(acc)
    assert tcsr.export_csr_delta(tprev, src, changed) is None
    assert jcsr.export_csr_delta(jprev, acc, changed) is None
    acc.abort()


def test_delta_export_ignores_session_fine_grained_filters():
    from memgraph_tpu.auth.auth import Auth
    from memgraph_tpu.auth.fine_grained import FgStorageView
    storage, vs, et = _storage()
    jprev, tprev, changed, acc = _prev_and_changed(
        storage, lambda: _mutate(storage, vs, et, 2, adds=20, removes=5))
    acc.abort()
    auth = Auth(None)
    auth.create_user("restricted", "pw")
    auth.grant("restricted", ["MATCH"])
    auth.grant_fine_grained("restricted", "edge_types", ["OTHER"], "READ")
    acc = storage.access()
    acc.fine_grained = FgStorageView(auth.fine_grained_checker("restricted"),
                                     storage)
    va = VertexAccessor(next(iter(storage._vertices.values())), acc)
    assert va.out_edges() == [] and va.in_edges() == []
    got = tcsr.export_csr_delta(tprev, StorageSource(acc), changed,
                                to_device=False)
    jgot = jcsr.export_csr_delta(jprev, acc, changed, to_device=False)
    acc.abort()
    plain = storage.access()
    want = tcsr.export_csr(StorageSource(plain), to_device=False)
    plain.abort()
    assert_same_snapshot(jgot, got)
    for f in FIELDS:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


# ---------------------------------------------------------------------------
# GraphCache: paths, lineage and refreshes (tests/test_plan_delta_e2e.py)
# ---------------------------------------------------------------------------

def test_graph_cache_chained_deltas_take_the_jax_paths(monkeypatch):
    storage, vs, et = _storage()
    twin = Twin(storage, monkeypatch)
    twin.get()
    for seed in (1, 2):
        _mutate(storage, vs, et, seed, adds=10, removes=3)
        twin.get()
    assert twin.tcache.counters == {"export.full": 1, "export.delta": 2}


def test_graph_cache_hit_and_a_new_vertex(monkeypatch):
    storage, vs, et = _storage(n=50, e=200)
    twin = Twin(storage, monkeypatch)
    acc = storage.access()
    tg = twin.tcache.get(StorageSource(acc), device="cpu")
    assert twin.tcache.get(StorageSource(acc), device="cpu") is tg
    assert twin.tcache.get(StorageSource(acc), device="cpu:0") is tg
    acc.abort()
    twin.jpaths["export.full"] += 1
    w = storage.access()
    w.create_vertex()
    w.commit()
    _, tg2 = twin.get()
    assert tg2 is not tg and tg2.n_nodes == 51
    assert twin.tcache.counters["export.full"] == 2


def test_graph_cache_keys_the_device_in_one_form():
    """"cpu" and "cpu:0" name one device and share one snapshot; the
    device, normalized, is the last part of every key."""
    import torch
    storage, vs, et = _storage(n=50, e=200)
    cache = tcsr.GraphCache()
    acc = storage.access()
    a = cache.get(StorageSource(acc), device="cpu")
    b = cache.get(StorageSource(acc), device=torch.device("cpu", 0))
    acc.abort()
    assert a is b and cache.counters["export.full"] == 1
    assert a.device == torch.device("cpu")
    assert [k[-1] for k in cache._cache[storage]] == [torch.device("cpu")]


def test_graph_cache_commit_made_after_the_view_began(monkeypatch):
    """A snapshot is keyed by its accessor's topology snapshot: a commit
    after the reader began is not in it (tests/test_csr_export.py)."""
    storage, vs, et = _storage(n=50, e=200)
    twin = Twin(storage, monkeypatch)
    writer = storage.access()
    writer.create_vertex()
    reader = storage.access()
    acc_j = twin.jcache.get(reader)
    acc_t = twin.tcache.get(StorageSource(reader), device="cpu")
    writer.commit()
    assert acc_t.n_nodes == acc_j.n_nodes == 50
    reader.abort()
    _, tg = twin.get()
    assert tg.n_nodes == 51


def test_commit_then_call_refreshes_from_the_jax_lineage(force_mxu,
                                                          monkeypatch):
    storage, vs, et = _storage(n=1500, e=9000, seed=3)
    twin = Twin(storage, monkeypatch)
    jg1, tg1 = twin.get(ranks=True)
    assert tg1._mxu_base_self and jg1._mxu_base_self
    _mutate(storage, vs, et, 7, adds=40, removes=10)
    jg2, tg2 = twin.get(ranks=True)
    assert jg2._delta_ctx[0] is jg1 and tg2._delta_ctx[0] is tg1
    assert tg2._mxu_state["plan"] is tg1._mxu_state["plan"]
    assert 0 < tg2._mxu_state["delta"].n_delta <= 50
    assert not getattr(tg2, "_mxu_base_self", False)


def test_edge_weight_set_invalidates_and_refreshes(force_mxu, monkeypatch):
    storage, vs, et = _storage(n=1500, e=9000, seed=3)
    wprop = storage.property_mapper.name_to_id("w")
    acc = storage.access()
    for ve in list(storage._edges.values())[:50]:
        EdgeAccessor(ve, acc).set_property(wprop, 5.0)
    acc.commit()
    twin = Twin(storage, monkeypatch)
    _, tg1 = twin.get(ranks=True, weight_property=wprop)
    acc = storage.access()
    EdgeAccessor(next(iter(storage._edges.values())),
                 acc).set_property(wprop, 250.0)
    acc.commit()
    _, tg2 = twin.get(ranks=True, weight_property=wprop)
    assert tg2._delta_ctx[0] is tg1 and 250.0 in tg2.weights.numpy()
    assert tg2._mxu_state["delta"].n_delta > 0


def test_huge_delta_recompacts(force_mxu, monkeypatch):
    storage, vs, et = _storage(n=1500, e=9000, seed=3)
    twin = Twin(storage, monkeypatch)
    _, tg1 = twin.get(ranks=True)
    _mutate(storage, vs, et, 9, adds=2700, removes=0)
    _, tg2 = twin.get(ranks=True)
    assert tg2._mxu_state["plan"] is not tg1._mxu_state["plan"]
    assert tg2._mxu_base_self


def test_chained_commits_refresh_from_the_original_base(force_mxu,
                                                         monkeypatch):
    storage, vs, et = _storage(n=1500, e=9000, seed=3)
    twin = Twin(storage, monkeypatch)
    jg1, tg1 = twin.get(ranks=True)
    for seed in (11, 12):
        _mutate(storage, vs, et, seed, adds=25, removes=0)
        jg, tg = twin.get(ranks=True)
        assert jg._delta_ctx[0] is jg1 and tg._delta_ctx[0] is tg1
        assert tg._mxu_state["base"] is tg1._mxu_state
    assert twin.tcache.counters["export.delta"] == 2


def test_a_wrapped_change_log_exports_in_full(force_mxu, monkeypatch):
    storage, vs, et = _storage(n=300, e=1500, seed=3)
    twin = Twin(storage, monkeypatch)
    twin.get(ranks=True)
    before = _jax_fallbacks()
    tbefore = _port_fallbacks()
    acc = storage.access()
    for _ in range(storage._change_log.maxlen + 1):
        acc.create_edge(vs[1], vs[2], et)
        acc.commit()
        acc = storage.access()
    acc.abort()
    _, tg = twin.get()
    assert _port_fallbacks() == tbefore + 1
    assert _jax_fallbacks() == before + 1
    assert not hasattr(tg, "_delta_ctx")
    assert twin.tcache.counters["export.full"] == 2


def test_an_untracked_bump_exports_in_full(force_mxu, monkeypatch):
    storage, vs, et = _storage(n=300, e=1500, seed=3)
    twin = Twin(storage, monkeypatch)
    twin.get(ranks=True)
    _mutate(storage, vs, et, 4, adds=5, removes=0)
    storage._bump_topology()
    tbefore = _port_fallbacks()
    _, tg = twin.get()
    assert _port_fallbacks() == tbefore + 1
    assert not hasattr(tg, "_delta_ctx")


# ---------------------------------------------------------------------------
# CooSource: the storage's contract without a storage
# ---------------------------------------------------------------------------

def test_coo_source_matches_the_storage_adapter():
    """One graph in a storage and in a CooSource; the same commits (edges
    added and removed, a weight set, a vertex added, an untracked bump)
    give the same change sets and the same snapshots, by the same
    paths."""
    n, e = 200, 1200
    storage, vs, et = _storage(n=n, e=e, seed=8)
    wprop = storage.property_mapper.name_to_id("weight")
    edges = list(storage._edges.values())
    gids = np.array([v.gid for v in vs])
    assert np.array_equal(gids, np.arange(n))
    coo = CooSource([ed.from_vertex.gid for ed in edges],
                    [ed.to_vertex.gid for ed in edges], n)
    scache, ccache = tcsr.GraphCache(), tcsr.GraphCache()
    rng = np.random.default_rng(1)
    fallbacks = {"storage": 0.0, "coo": 0.0}

    def counted(kind, cache, source, **kw):
        """``cache.get``, its full exports forced by an unknowable log
        added to ``fallbacks[kind]``."""
        before = _port_fallbacks()
        g = cache.get(source, **kw)
        fallbacks[kind] += _port_fallbacks() - before
        return g

    def snap():
        """Both weight views of both sources, each storage view from one
        accessor (its abort bumps the storage's version)."""
        acc = storage.access()
        for wp in (None, wprop):
            a = counted("storage", scache, StorageSource(acc),
                        weight_property=wp, device="cpu")
            b = counted("coo", ccache, coo,
                        weight_property=None if wp is None else "weight",
                        device="cpu")
            for f in FIELDS + ("col_ptr",):
                assert np.array_equal(getattr(a, f).numpy(),
                                      getattr(b, f).numpy()), f
            assert np.array_equal(a.node_gids, b.node_gids)
            assert scache.counters == ccache.counters
            assert fallbacks["storage"] == fallbacks["coo"]
        acc.abort()

    def commit(add=(), remove=(), weights=None, new_vertex=False):
        acc = storage.access()
        for i in remove:
            acc.delete_edge(EdgeAccessor(edges[i], acc))
        if weights is not None:
            for i, w in zip(*weights):
                EdgeAccessor(edges[i], acc).set_property(wprop, float(w))
        add_src, add_dst = [], []
        if new_vertex:
            nv = acc.create_vertex()
            vs.append(nv)
        for s, d in add:
            edges.append(acc.create_edge(
                acc.find_vertex(vs[s].gid), acc.find_vertex(vs[d].gid), et))
            add_src.append(s)
            add_dst.append(d)
        v_from = storage.topology_version
        acc.commit()
        c = coo.commit(add_src, add_dst, remove=list(remove),
                       set_weights=weights, add_vertices=int(new_vertex))
        assert storage.changes_between(v_from, storage.topology_version) \
            == c == coo.changes_between(coo.version - 1, coo.version)

    snap()
    alive = lambda: coo.alive_ids()  # noqa: E731
    commit(add=[tuple(p) for p in rng.integers(0, n, (15, 2))],
           remove=rng.choice(alive(), 6, replace=False))
    snap()
    commit(weights=(rng.choice(alive(), 4, replace=False),
                    rng.random(4) * 5))
    snap()
    commit(add=[tuple(p) for p in rng.integers(0, n, (5, 2))],
           remove=rng.choice(alive(), 3, replace=False))
    snap()
    # storing a version drops the older ones of every weight view (the
    # reference's eviction), so the weighted view after the unweighted
    # one exports in full
    assert scache.counters["export.delta"] == 3
    commit(add=[(n, 3)], new_vertex=True)
    snap()
    storage._bump_topology()
    coo.untracked_bump()
    assert isinstance(coo.changes_between(coo.version - 1, coo.version),
                      tcsr.ChangeLogUnknowable)
    snap()
    assert fallbacks["storage"] == 1


def test_coo_source_log_wraps_as_the_storage_does():
    coo = CooSource([0, 1], [1, 0], 3, log_size=4)
    for _ in range(4):
        coo.commit([2], [0])
    assert coo.changes_between(0, 4) == frozenset({0, 2})
    coo.commit([2], [1])
    wrapped = coo.changes_between(0, 5)
    assert isinstance(wrapped, tcsr.ChangeLogUnknowable) and not wrapped
    assert wrapped.reason == "log_wrapped" and coo.oldest_logged_version == 2
    assert coo.changes_between(1, 5) == frozenset({0, 1, 2})
    assert coo.changes_between(5, 5) == frozenset()
    with pytest.raises(ValueError):
        coo.commit(remove=[0, 0, 99])
    with pytest.raises(ValueError):
        coo.vertices(label_filter=1)


def test_coercion_matches_the_jax_package():
    for v in (2.5, 3, True, None, "x", float("inf"), -0.0):
        a, b = jcsr._coerce_weight(v), tcsr._coerce_weight(v)
        assert a == b or (np.isnan(a) and np.isnan(b))
