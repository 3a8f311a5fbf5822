"""The port's columnar snapshots (memgraph_tpu_torch/ops/columnar.py)
against the JAX package's on one ``InMemoryStorage``.

The port reads the storage through ``StorageSource``
(tests/test_torch_snapshot.py), extended here by ``edge_keys`` (the edge
gids and type ids in the source's edge order); the JAX package's
``export_columns`` / ``export_edges`` read the accessor itself.  Columns
are compared exactly: kind, dtype and values, ``present``, ``vocab``,
``big`` and ``mixed``, over big ints (past 2^53 and past int64), mixed
ints and floats, strings, bools, lists and absent values.
"""

import numpy as np
import pytest

from memgraph_tpu.ops import columnar as jcol
from memgraph_tpu.storage import InMemoryStorage, StorageConfig, StorageMode
from memgraph_tpu.storage.common import View
from memgraph_tpu.storage.storage import EdgeAccessor
from memgraph_tpu_torch.northstar import CooSource
from memgraph_tpu_torch.ops import columnar as tcol
from test_torch_snapshot import StorageSource

import torch

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

N = 240

#: property name -> value of vertex i (None: absent)
PROPS = {
    "small": lambda i, r: int(r.integers(-50, 50)),
    "big": lambda i, r: 2**60 + i if i % 7 == 0 else i,
    "huge": lambda i, r: 2**70 if i == 5 else i,
    "mixed": lambda i, r: float(i) / 3 if i % 2 else i,
    "mixed_big": lambda i, r: 0.5 if i == 3 else (2**54 if i == 4 else i),
    "name": lambda i, r: ["red", "green", "blue"][i % 3]
    if i % 5 else None,
    "flag": lambda i, r: bool(i % 2) if i % 4 else None,
    "sparse": lambda i, r: i * 11 if i % 10 == 0 else None,
    "listy": lambda i, r: [i, i + 1] if i % 3 == 0 else None,
    "bool_int": lambda i, r: True if i % 2 else 1,
    "floats": lambda i, r: float(r.random()) - 0.5,
}
PROP_NAMES = tuple(PROPS) + ("missing",)


class ColumnSource(StorageSource):
    """StorageSource with the edges' own gids and type ids."""

    def edge_keys(self):
        gids, types = [], []
        for edge in list(self.storage._edges.values()):
            if edge.delta is None:
                if edge.deleted:
                    continue
            elif not EdgeAccessor(edge, self.accessor).is_visible(View.OLD):
                continue
            gids.append(edge.gid)
            types.append(edge.edge_type)
        return gids, types


@pytest.fixture(scope="module")
def db():
    storage = InMemoryStorage(StorageConfig(
        storage_mode=StorageMode.IN_MEMORY_TRANSACTIONAL))
    rng = np.random.default_rng(3)
    acc = storage.access()
    label = storage.label_mapper.name_to_id("P")
    pids = {p: storage.property_mapper.name_to_id(p) for p in PROPS}
    vs = []
    for i in range(N):
        v = acc.create_vertex()
        if i % 3:
            v.add_label(label)
        for p, fn in PROPS.items():
            val = fn(i, rng)
            if val is not None:
                v.set_property(pids[p], val)
        vs.append(v)
    etypes = [storage.edge_type_mapper.name_to_id(t) for t in ("E", "R")]
    wp = storage.property_mapper.name_to_id("w")
    tp = storage.property_mapper.name_to_id("tag")
    for k in range(900):
        a, b = rng.integers(0, N, 2)
        e = acc.create_edge(vs[a], vs[b], etypes[k % 2])
        if k % 4:
            e.set_property(wp, int(rng.integers(0, 1000)))
        e.set_property(tp, "x" if k % 3 else 2.5)
    acc.commit()
    return storage


def assert_same_column(jc, tc, what):
    assert (jc.kind, jc.big, jc.mixed) == (tc.kind, tc.big, tc.mixed), what
    assert np.array_equal(jc.present, tc.present), what
    assert jc.vocab == tc.vocab, what
    if jc.values is None:
        assert tc.values is None, what
    else:
        assert jc.values.dtype == tc.values.dtype, what
        assert np.array_equal(jc.values, tc.values), what


@pytest.mark.parametrize("label", [None, "P"])
def test_export_columns_equal_the_reference(db, label):
    acc = db.access()
    want = jcol.export_columns(acc, label, PROP_NAMES, View.OLD)
    lid = None if label is None else db.label_mapper.name_to_id(label)
    got = tcol.export_columns(ColumnSource(acc), lid, PROP_NAMES)
    assert got.n == want.n
    assert np.array_equal(got.gids, want.gids)
    for p in PROP_NAMES:
        assert_same_column(want.columns[p], got.columns[p], p)
    kinds = {p: got.columns[p].kind for p in PROP_NAMES}
    if label is not None:
        acc.abort()
        return
    assert kinds["big"] == "int" and got.columns["big"].big
    assert kinds["huge"] == "other" and kinds["mixed_big"] == "other"
    assert kinds["mixed"] == "float" and got.columns["mixed"].mixed
    assert kinds["bool_int"] == "other" and kinds["listy"] == "other"
    assert (kinds["name"], kinds["flag"]) == ("str", "bool")
    acc.abort()


def test_export_edges_equal_the_reference(db):
    acc = db.access()
    want = jcol.export_edges(acc, ("w", "tag", "missing"), View.OLD)
    got = tcol.export_edges(ColumnSource(acc), ("w", "tag", "missing"))
    assert got.n == want.n
    for f in ("gids", "src", "dst", "type_ids"):
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for p in ("w", "tag", "missing"):
        assert_same_column(want.columns[p], got.columns[p], p)
    acc.abort()


@pytest.mark.parametrize("values", [
    np.arange(-5, 5, dtype=np.int32),
    np.array([0, 2**60, -2**60], dtype=np.int64),
    np.array([1.5, -2.0], dtype=np.float32),
    np.array([True, False, True]),
    np.array([2**63 + 1, 3], dtype=np.uint64),
])
def test_numeric_array_fast_path_equals_classify(values):
    """A source answering with a numpy array takes a vectorized path; it
    gives what the reference's classification of the same values does."""
    fast = tcol._column(values, len(values))
    vals = values.tolist()
    slow = jcol._classify(vals, np.ones(len(vals), dtype=bool))
    assert_same_column(slow, fast, values.dtype)


def test_cache_shares_columns_within_a_version():
    props = {"age": np.arange(50) % 7, "score": np.arange(50) * 2}
    src = CooSource(np.arange(49), np.arange(1, 50), 50, properties=props)
    cache = tcol.ColumnarCache()
    a = cache.get(src, None, ("age",))
    b = cache.get(src, None, ("age", "score"))
    assert a is b and set(b.columns) == {"age", "score"}
    assert cache.get(src, None, ("score",)) is a
    assert np.array_equal(b.columns["score"].values, props["score"])
    e1 = cache.get_edges(src, ("weight",))
    assert e1.n == 49 and cache.get_edges(src, ("weight",)) is e1
    src.commit(add_src=[0], add_dst=[5])
    c = cache.get(src, None, ("age",))
    assert c is not a and set(c.columns) == {"age"}
    assert cache.get_edges(src, ()).n == 50
