"""The port's MVCC storage (memgraph_tpu_torch/storage) against the JAX
package's on the CPU.

Each scenario drives the same transactions, step by step, on a storage of
each package, and records what a client observes: the gids handed out,
what each transaction sees under each isolation level and view, index
lookups, the serialization conflicts and constraint violations (class
name and message), the change log and the garbage collector's counts.
The two records are compared exactly.

Also here: the port's snapshot source (storage/source.py) over its own
storage against the tests' adapter over the JAX storage
(tests/test_torch_snapshot.py's ``StorageSource``) after the same
commits, field by field, and the CSR snapshots the port's ``GraphCache``
builds from each, array by array.
"""

import types

import numpy as np
import pytest
import torch

import memgraph_tpu.exceptions as JE
import memgraph_tpu.storage as JS
import memgraph_tpu.storage.common as JC
import memgraph_tpu_torch.exceptions as TE
import memgraph_tpu_torch.storage as TS
import memgraph_tpu_torch.storage.common as TC
from memgraph_tpu_torch.ops import csr as tcsr
from memgraph_tpu_torch.storage.source import StorageSource as PortSource
from test_torch_snapshot import FIELDS, StorageSource as JaxAdapter

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

JAX = types.SimpleNamespace(S=JS, C=JC, E=JE)
PORT = types.SimpleNamespace(S=TS, C=TC, E=TE)


def plain(v):
    """A value with the storage's objects replaced by their gids."""
    if isinstance(v, (list, tuple)):
        return tuple(plain(x) for x in v)
    return int(v.gid) if hasattr(v, "gid") else v


def outcome(fn):
    """fn()'s value, or its error as (class name, message)."""
    try:
        return ("ok", plain(fn()))
    except Exception as e:  # noqa: BLE001 — the error is the outcome
        return ("error", type(e).__name__, str(e))


def visible(acc, view_name="OLD", pk=None):
    """(gid, labels, properties) of every vertex and (gid, type, from, to,
    properties) of every edge the accessor sees at the view."""
    view = getattr(pk.C.View, view_name)
    vs = sorted((int(v.gid), tuple(sorted(v.labels(view))),
                 tuple(sorted(v.properties(view).items())))
                for v in acc.vertices(view))
    es = sorted((int(e.gid), e.edge_type, int(e.from_vertex().gid),
                 int(e.to_vertex().gid),
                 tuple(sorted(e.properties(view).items())))
                for e in acc.edges(view))
    return vs, es


def new_storage(pk, **cfg):
    st = pk.S.InMemoryStorage(pk.S.StorageConfig(**cfg))
    names = types.SimpleNamespace(
        L=st.label_mapper.name_to_id("L"), M=st.label_mapper.name_to_id("M"),
        p=st.property_mapper.name_to_id("p"),
        q=st.property_mapper.name_to_id("q"),
        E=st.edge_type_mapper.name_to_id("E"))
    return st, names


def seed(st, n, k=6):
    acc = st.access()
    vs = []
    for i in range(k):
        v = acc.create_vertex()
        v.add_label(n.L)
        v.set_property(n.p, i)
        vs.append(v)
    for i in range(k - 1):
        acc.create_edge(vs[i], vs[i + 1], n.E).set_property(n.q, i * 0.5)
    acc.commit()
    return [int(v.gid) for v in vs]


# --- scenarios: each returns the list of what it observed ------------------


def sc_commit_and_gids(pk):
    st, n = new_storage(pk)
    rec = [seed(st, n)]
    acc = st.access()
    v = acc.create_vertex()
    w = acc.create_vertex()
    e = acc.create_edge(v, w, n.E)
    rec.append((int(v.gid), int(w.gid), int(e.gid)))
    rec.append(visible(acc, "NEW", pk))
    rec.append(visible(acc, "OLD", pk))
    acc.commit()
    rec.append(visible(st.access(), "OLD", pk))
    return rec


def sc_isolation(pk, level):
    st, n = new_storage(pk)
    gids = seed(st, n)
    iso = getattr(pk.C.IsolationLevel, level)
    reader = st.access(iso)
    rec = [visible(reader, pk=pk)]
    writer = st.access()
    writer.create_vertex().add_label(n.M)
    writer.find_vertex(gids[0]).set_property(n.p, 100)
    rec.append(visible(reader, pk=pk))       # uncommitted writes
    writer.commit()
    rec.append(visible(reader, pk=pk))       # after the commit
    deleter = st.access()
    deleter.delete_vertex(deleter.find_vertex(gids[-1]), detach=True)
    deleter.abort()
    rec.append(visible(reader, pk=pk))
    reader.abort()
    return rec


def sc_write_conflict(pk):
    st, n = new_storage(pk)
    gids = seed(st, n)
    a, b = st.access(), st.access()
    rec = [outcome(lambda: a.find_vertex(gids[1]).set_property(n.p, -1))]
    rec.append(outcome(lambda: b.find_vertex(gids[1]).set_property(n.p, -2)))
    rec.append(outcome(lambda: b.delete_vertex(b.find_vertex(gids[2]),
                                               detach=True)))
    rec.append(outcome(lambda: a.find_vertex(gids[2]).add_label(n.M)))
    rec.append(outcome(a.commit))
    rec.append(outcome(b.abort))
    rec.append(visible(st.access(), pk=pk))
    return rec


def sc_delete_and_abort(pk):
    st, n = new_storage(pk)
    gids = seed(st, n)
    acc = st.access()
    rec = [outcome(lambda: acc.delete_vertex(acc.find_vertex(gids[2])))]
    acc2 = st.access()
    rec.append(outcome(lambda: acc2.delete_vertex(acc2.find_vertex(gids[2]),
                                                  detach=True)))
    rec.append(visible(acc2, "NEW", pk))
    acc2.abort()
    rec.append(visible(st.access(), pk=pk))
    acc3 = st.access()
    ea = next(iter(acc3.edges()))
    rec.append(outcome(lambda: acc3.delete_edge(ea) and None))
    rec.append(outcome(acc3.commit))
    rec.append(visible(st.access(), pk=pk))
    return rec


def sc_constraints(pk):
    st, n = new_storage(pk)
    gids = seed(st, n)
    rec = [outcome(lambda: st.create_unique_constraint(n.L, (n.p,)))]
    acc = st.access()
    v = acc.create_vertex()
    v.add_label(n.L)
    v.set_property(n.p, 3)
    rec.append(outcome(acc.commit))
    rec.append(outcome(lambda: st.create_existence_constraint(n.M, n.q)))
    acc = st.access()
    acc.create_vertex().add_label(n.M)
    rec.append(outcome(acc.commit))
    rec.append(outcome(lambda: st.create_type_constraint(n.L, n.q,
                                                         "INTEGER")))
    acc = st.access()
    acc.find_vertex(gids[0]).set_property(n.q, "text")
    rec.append(outcome(acc.commit))
    acc = st.access()
    acc.find_vertex(gids[0]).set_property(n.q, 7)
    rec.append(outcome(acc.commit))
    # a constraint that the data already breaks cannot be created
    acc = st.access()
    w = acc.create_vertex()
    w.add_label(n.L)
    w.set_property(n.p, 99)
    w.set_property(n.q, 7)
    acc.commit()
    rec.append(outcome(lambda: st.create_unique_constraint(n.L, (n.q,))))
    rec.append(visible(st.access(), pk=pk))
    return rec


def sc_batch_insert(pk):
    st, n = new_storage(pk)
    gids = seed(st, n)
    acc = st.access()
    old = acc.find_vertex(gids[0])
    vs, es = acc.batch_insert(
        vertices=[((n.L,), {n.p: 100 + i}) for i in range(5)],
        edges=[(n.E, 0, 1, {n.q: 1.0}), (n.E, old, 4, {}), (n.E, 3, 3, {})])
    rec = [[int(v.gid) for v in vs], [int(e.gid) for e in es]]
    other = st.access()
    rec.append(visible(other, pk=pk))
    acc.commit()
    rec.append(visible(st.access(), pk=pk))
    acc = st.access()
    acc.batch_insert(vertices=[((n.M,), {})] * 3)
    acc.abort()
    rec.append(visible(st.access(), pk=pk))
    return rec


def sc_indexes(pk):
    st, n = new_storage(pk)
    seed(st, n, k=20)
    st.create_label_index(n.L)
    st.create_label_property_index(n.L, (n.p,))
    st.create_edge_type_index(n.E)
    acc = st.access()
    rec = [sorted(int(v.gid) for v in acc.vertices_by_label(n.L))]
    rec.append([int(v.gid) for v in acc.vertices_by_label_property_value(
        n.L, (n.p,), (7,))])
    rec.append([int(v.gid) for v in acc.vertices_by_label_property_range(
        n.L, (n.p,), lower=3, upper=9, upper_inclusive=False)])
    rec.append(sorted(int(e.gid) for e in acc.edges_by_type(n.E)))
    rec.append((acc.approx_vertex_count(n.L),
                acc.approx_vertex_count(n.L, (n.p,)),
                acc.approx_edge_count()))
    return rec


def sc_change_log_and_gc(pk):
    st, n = new_storage(pk)
    v0 = st.topology_version
    gids = seed(st, n)
    rec = [st.topology_version - v0]
    v1 = st.topology_version
    acc = st.access()
    acc.find_vertex(gids[2]).set_property(n.p, 9)
    acc.commit()
    acc = st.access()
    acc.create_edge(acc.find_vertex(gids[0]), acc.find_vertex(gids[4]), n.E)
    acc.commit()
    v2 = st.topology_version
    rec.append((v2 - v1, sorted(st.changes_between(v1, v2)),
                sorted(st.changes_between(v1, v1 + 1))))
    acc = st.access()
    acc.delete_vertex(acc.find_vertex(gids[5]), detach=True)
    acc.commit()
    rec.append(st.collect_garbage())
    rec.append(visible(st.access(), pk=pk))
    return rec


def sc_views_within_a_transaction(pk):
    st, n = new_storage(pk)
    gids = seed(st, n)
    acc = st.access()
    v = acc.find_vertex(gids[1])
    v.set_property(n.p, 50)
    v.add_label(n.M)
    rec = [(v.get_property(n.p, pk.C.View.OLD),
            v.get_property(n.p, pk.C.View.NEW),
            sorted(v.labels(pk.C.View.OLD)), sorted(v.labels(pk.C.View.NEW)),
            v.out_degree(pk.C.View.NEW), v.in_degree(pk.C.View.OLD))]
    acc.abort()
    return rec


def sc_analytical_mode(pk):
    st, n = new_storage(
        pk, storage_mode=pk.C.StorageMode.IN_MEMORY_ANALYTICAL)
    gids = seed(st, n)
    acc = st.access()
    acc.find_vertex(gids[0]).set_property(n.p, 77)
    other = st.access()
    rec = [visible(other, pk=pk)]       # no MVCC: visible at once
    acc.abort()
    rec.append(visible(st.access(), pk=pk))
    return rec


SCENARIOS = {
    "commit_and_gids": sc_commit_and_gids,
    "isolation_snapshot": lambda pk: sc_isolation(pk, "SNAPSHOT_ISOLATION"),
    "isolation_read_committed": lambda pk: sc_isolation(pk,
                                                        "READ_COMMITTED"),
    "isolation_read_uncommitted": lambda pk: sc_isolation(
        pk, "READ_UNCOMMITTED"),
    "write_conflict": sc_write_conflict,
    "delete_and_abort": sc_delete_and_abort,
    "constraints": sc_constraints,
    "batch_insert": sc_batch_insert,
    "indexes": sc_indexes,
    "change_log_and_gc": sc_change_log_and_gc,
    "views_within_a_transaction": sc_views_within_a_transaction,
    "analytical_mode": sc_analytical_mode,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_the_reference(name):
    assert SCENARIOS[name](PORT) == SCENARIOS[name](JAX)


def test_conflicts_and_violations_are_raised():
    """The scenarios see the errors they are about, typed as the
    reference types them."""
    conflict = sc_write_conflict(PORT)
    assert conflict[1][:2] == ("error", "SerializationError")
    violations = [r for r in sc_constraints(PORT)
                  if r[0] == "error" and r[1] == "ConstraintViolation"]
    assert len(violations) >= 4
    assert issubclass(TE.SerializationError, TE.StorageError)


# --- the snapshot source -------------------------------------------------------


def _graph(pk, seed_=5, n_v=300, n_e=1800):
    """Both storages get the same vertices (some labelled L), edges (a
    weight on most) and then a commit that changes a few."""
    st, n = new_storage(pk)
    rng = np.random.default_rng(seed_)
    acc = st.access()
    vs = []
    for i in range(n_v):
        v = acc.create_vertex()
        if i % 3:
            v.add_label(n.L)
        v.set_property(n.p, int(rng.integers(0, 1000)))
        vs.append(v)
    for k in range(n_e):
        a, b = rng.integers(0, n_v, 2)
        e = acc.create_edge(vs[a], vs[b], n.E)
        if k % 5:
            e.set_property(n.q, float(rng.random()))
    acc.commit()
    v_before = st.topology_version
    acc = st.access()
    for k in range(40):
        a, b = rng.integers(0, n_v, 2)
        acc.create_edge(acc.find_vertex(int(vs[a].gid)),
                        acc.find_vertex(int(vs[b].gid)), n.E)
    acc.delete_vertex(acc.find_vertex(int(vs[7].gid)), detach=True)
    acc.commit()
    return st, n, v_before


@pytest.fixture(scope="module")
def sources():
    jst, jn, jv = _graph(JAX)
    tst, tn, tv = _graph(PORT)
    assert (jv, jn.L) == (tv, tn.L)
    return (jst, jn, jv), (tst, tn, tv)


def test_the_source_reads_what_the_adapter_reads(sources):
    (jst, jn, jv), (tst, tn, tv) = sources
    ja, ta = JaxAdapter(jst.access()), PortSource(tst.access())
    assert ja.version == ta.version
    assert ja.vertices() == ta.vertices()
    assert ja.vertices(jn.L) == ta.vertices(tn.L)
    for wp in (None, "q", tn.q, "nosuch"):
        assert ja.edges(wp) == ta.edges(wp), wp
    assert ja.changes_between(jv, ja.version) == \
        ta.changes_between(tv, ta.version)
    gids = ta.vertices()[::7] + [10**9]
    assert ja.vertex_property("p", gids) == ta.vertex_property("p", gids)
    assert ta.vertex_property("nosuch", gids) is None
    assert ja.vertex_records(gids) == ta.vertex_records(gids)
    for g in gids[:20]:
        assert ja.incident(g, "q") == ta.incident(g, "q")
        assert ja.incident(g, None, None, jn.L) == \
            ta.incident(g, None, None, tn.L)


@pytest.mark.parametrize("wp,label", [(None, None), ("q", None),
                                      (None, "L")])
def test_snapshots_of_the_port_storage_equal_the_adapters(sources, wp,
                                                          label):
    (jst, jn, _), (tst, tn, _) = sources
    lf = None if label is None else jn.L
    jg = tcsr.GraphCache().get(JaxAdapter(jst.access()), weight_property=wp,
                               label_filter=lf, device="cpu")
    tg = tcsr.GraphCache().get(PortSource(tst.access()), weight_property=wp,
                               label_filter=lf, device="cpu")
    assert np.array_equal(jg.node_gids, tg.node_gids)
    assert (jg.n_nodes, jg.n_edges) == (tg.n_nodes, tg.n_edges)
    for f in FIELDS:
        assert torch.equal(getattr(jg, f), getattr(tg, f)), f


def test_a_commit_is_refreshed_by_delta_from_the_port_storage():
    st, n = new_storage(PORT)
    gids = seed(st, n, k=50)
    cache = tcsr.GraphCache()
    g0 = cache.get(PortSource(st.access()), device="cpu")
    acc = st.access()
    acc.create_edge(acc.find_vertex(gids[3]), acc.find_vertex(gids[9]), n.E)
    acc.commit()
    g1 = cache.get(PortSource(st.access()), device="cpu")
    assert cache.counters == {"export.full": 1, "export.delta": 1}
    assert g1.n_edges == g0.n_edges + 1
    full = tcsr.GraphCache().get(PortSource(st.access()), device="cpu")
    for f in FIELDS:
        assert torch.equal(getattr(g1, f), getattr(full, f)), f


class _OnlyLabel:
    """A fine-grained view that reads only vertices with the label id
    ``lid`` (and the edges between them)."""

    def __init__(self, lid):
        self.lid = lid

    def can_read_vertex(self, labels):
        return self.lid in labels

    def can_read_edge(self, edge_type):
        return True


@pytest.mark.parametrize("fine_grained", [False, True])
def test_the_scan_source_reads_what_the_reference_export_reads(
        sources, fine_grained):
    """The lane's columnar exports through ``ScanSource`` equal the JAX
    package's ``export_columns`` / ``export_edges`` of the accessor, with
    and without a fine-grained view (then never shared)."""
    from memgraph_tpu.ops import columnar as jcol
    from memgraph_tpu_torch.ops import columnar as tcol
    from memgraph_tpu_torch.storage.source import ScanSource
    (jst, jn, _), (tst, tn, _) = sources
    jacc, tacc = jst.access(), tst.access()
    if fine_grained:
        jacc.fine_grained = _OnlyLabel(jn.L)
        tacc.fine_grained = _OnlyLabel(tn.L)
    src = ScanSource(tacc, TC.View.OLD)
    assert src.cacheable is not fine_grained
    for label, lid in ((None, None), ("L", tn.L)):
        want = jcol.export_columns(jacc, label, ("p", "nosuch"),
                                   JC.View.OLD)
        got = tcol.export_columns(ScanSource(tacc, TC.View.OLD), lid,
                                  ("p", "nosuch"))
        assert np.array_equal(want.gids, got.gids), label
        for p in ("p", "nosuch"):
            w, g = want.columns[p], got.columns[p]
            assert (w.kind, np.array_equal(w.present, g.present)) == \
                (g.kind, True), p
            if w.values is not None:
                assert np.array_equal(w.values, g.values), p
    want = jcol.export_edges(jacc, ("q",), JC.View.OLD)
    got = tcol.export_edges(src, ("q",))
    for f in ("gids", "src", "dst", "type_ids"):
        assert np.array_equal(getattr(want, f), getattr(got, f)), f
    assert np.array_equal(want.columns["q"].values, got.columns["q"].values)
    assert np.array_equal(want.columns["q"].present,
                          got.columns["q"].present)
    assert fine_grained == (got.n < len(PortSource(tacc).edges()[0]))
