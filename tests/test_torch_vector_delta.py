"""The port's vector index maintenance (memgraph_tpu_torch/procedures/
vector_search.py: ``IndexCache``'s choice of alias, delta refresh or full
build, and ``_delta_refresh``) against the JAX package's ``_get_index``
on one storage over a sequence of commits: changes, clears, inserts
(freed rows reused, then the matrix grown), deleted vertices,
off-dimension values, an unchanged version, a dominant-dimension flip
and a wrapped change log.

After each commit the two entries are compared exactly: version,
dimension, ``row_gids``, ``gid_to_row``, ``free_rows``, ``dim_counts``,
``offdim``, the matrix's shape and live rows, and ``valid``; the port's
``counters`` move as the JAX package's ``STATS``.  ``CooSource``'s
vertex-property commits (``set_properties``) are held against a full
build of the same state.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from memgraph_tpu.procedures import vector_search as jvs
from memgraph_tpu.storage import InMemoryStorage
from memgraph_tpu.storage.common import View
from memgraph_tpu_torch.northstar import CooSource
from memgraph_tpu_torch.ops.csr import property_rows
from memgraph_tpu_torch.procedures import vector_search as VS

from test_torch_snapshot import StorageSource

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

DIM, N = 8, 80


class Twin:
    """A storage of vertices with an ``emb`` property, the JAX index over
    it and the port's (its own IndexCache)."""

    def __init__(self, seed=3, dims=None):
        """``dims``: each initial vertex's dimension (None: no property);
        by default N vertices, some without the property, some of an
        off dimension (4)."""
        self.rng = np.random.default_rng(seed)
        self.storage = InMemoryStorage()
        self.emb = self.storage.property_mapper.name_to_id("emb")
        self.cache = VS.IndexCache()
        if dims is None:
            dims = [None if i % 13 == 5 else 4 if i % 17 == 3 else DIM
                    for i in range(N)]
        acc = self.storage.access()
        vs = [acc.create_vertex() for _ in dims]
        self.gids = [v.gid for v in vs]
        for v, dim in zip(vs, dims):
            if dim is not None:
                v.set_property(self.emb, self.vec(dim))
        acc.commit()

    def vec(self, dim=DIM):
        return [float(x) for x in self.rng.standard_normal(dim)]

    def commit(self, sets=(), clears=(), new=(), deletes=()):
        """Set ``sets`` (gid -> value), clear ``clears``, create a vertex
        for each value of ``new`` (None: no property), delete
        ``deletes``."""
        acc = self.storage.access()
        for g, value in dict(sets).items():
            acc.find_vertex(g, View.OLD).set_property(self.emb, value)
        for g in clears:
            acc.find_vertex(g, View.OLD).set_property(self.emb, None)
        for value in new:
            v = acc.create_vertex()
            self.gids.append(v.gid)
            if value is not None:
                v.set_property(self.emb, value)
        for g in deletes:
            acc.delete_vertex(acc.find_vertex(g, View.OLD))
            self.gids.remove(g)
        acc.commit()

    def entries(self):
        """(JAX entry, port entry, JAX STATS moves, port counter moves)
        at the storage's newest version."""
        before = (dict(jvs.STATS), dict(self.cache.counters))
        acc = self.storage.access()
        try:
            ctx = SimpleNamespace(storage=self.storage, accessor=acc,
                                  view=View.OLD)
            want = jvs._get_index(ctx, "emb")
            got = self.cache.get(StorageSource(acc), "emb", "cpu")
        finally:
            acc.commit()
        moves = ({k: jvs.STATS[k] - before[0][k] for k in jvs.STATS},
                 {k: self.cache.counters[k] - before[1][k]
                  for k in self.cache.counters})
        return want, got, moves

    def check(self):
        want, got, (jmoves, tmoves) = self.entries()
        assert jmoves == tmoves
        assert (got.version, got.dim) == (want.version, want.dim)
        assert got.row_gids == want.row_gids
        assert got.gid_to_row == want.gid_to_row
        assert got.free_rows == want.free_rows
        # in the same order: a tie of the counts goes to the first seen
        assert list(got.dim_counts.items()) == list(want.dim_counts.items())
        assert got.offdim == want.offdim
        if want.matrix is None:
            assert got.matrix is None
            return want, got, tmoves
        wm, gm = np.asarray(want.matrix), got.matrix.numpy()
        assert gm.shape == wm.shape and gm.dtype == np.float32
        live = [r for r, g in enumerate(want.row_gids) if g is not None]
        assert np.array_equal(gm[live], wm[live])
        assert np.array_equal(got.valid.numpy(), np.asarray(want.valid))
        return want, got, tmoves


def test_a_sequence_of_commits_follows_the_reference():
    twin = Twin()
    _, got, moves = twin.check()
    assert moves == {"full_builds": 1, "delta_refreshes": 0}
    assert got.offdim and got.dim == DIM
    g = twin.gids
    # changes and clears: rows freed
    twin.commit(sets={g[0]: twin.vec(), g[1]: twin.vec(), g[2]: twin.vec()},
                clears=[g[6], g[7], g[8]])
    _, got, moves = twin.check()
    assert moves == {"full_builds": 0, "delta_refreshes": 1}
    assert len(got.free_rows) == 3
    # inserts take the freed rows last in, first out, then grow; an
    # off-dimension value holds no row; a vector on a vertex that had
    # none
    twin.commit(new=[twin.vec(), twin.vec(4), None, twin.vec(), twin.vec(),
                     twin.vec(), twin.vec()],
                sets={g[5]: twin.vec(), g[3]: twin.vec()})
    _, got, moves = twin.check()
    assert moves == {"full_builds": 0, "delta_refreshes": 1}
    assert not got.free_rows and got.matrix.shape[0] > len(got.row_gids) - 1
    # deleted vertices read as None
    twin.commit(deletes=[g[10], g[11]])
    _, got, moves = twin.check()
    assert moves == {"full_builds": 0, "delta_refreshes": 1}
    # growth past the capacity by max(16, capacity)
    twin.commit(new=[twin.vec() for _ in range(40)])
    _, got, moves = twin.check()
    assert moves == {"full_builds": 0, "delta_refreshes": 1}
    # a version with no changed vertex aliases the parent
    twin.storage._bump_topology(set())
    want, got, moves = twin.check()
    assert moves == {"full_builds": 0, "delta_refreshes": 0}
    # the dominant dimension flips: a full build
    flip = [x for x in twin.gids if x in got.gid_to_row][:60]
    twin.commit(sets={x: twin.vec(4) for x in flip})
    _, got, moves = twin.check()
    assert moves == {"full_builds": 1, "delta_refreshes": 0}
    assert got.dim == 4
    # a wrapped change log: a full build
    twin.commit(sets={twin.gids[0]: twin.vec(4)})
    for _ in range(1100):
        twin.storage._bump_topology({twin.gids[1]})
    _, got, moves = twin.check()
    assert moves == {"full_builds": 1, "delta_refreshes": 0}


def test_a_large_change_rebuilds_in_full():
    twin = Twin(seed=5)
    twin.check()
    twin.commit(sets={x: twin.vec() for x in twin.gids[:70]})
    _, _, moves = twin.check()
    assert moves == {"full_builds": 1, "delta_refreshes": 0}


def test_an_index_of_no_vector_stays_so_then_builds():
    storage = InMemoryStorage()
    emb = storage.property_mapper.name_to_id("emb")
    twin = Twin.__new__(Twin)
    twin.rng, twin.storage, twin.emb = np.random.default_rng(1), storage, emb
    twin.cache = VS.IndexCache()
    acc = storage.access()
    vs = [acc.create_vertex() for _ in range(5)]
    twin.gids = [v.gid for v in vs]
    vs[0].set_property(emb, "text")
    acc.commit()
    _, got, moves = twin.check()
    assert got.dim is None and moves["full_builds"] == 1
    twin.commit(new=[None])
    _, got, moves = twin.check()
    # a new entry of no rows, counted as neither (as the JAX package)
    assert got.dim is None and got.version == 2
    assert moves == {"full_builds": 0, "delta_refreshes": 0}
    twin.commit(sets={twin.gids[1]: twin.vec()})
    _, got, moves = twin.check()
    assert got.dim == DIM and moves["full_builds"] == 1


def test_a_tie_of_dimensions_goes_to_the_first_seen():
    twin = Twin(dims=[4, DIM, DIM, 4, None])
    _, got, _ = twin.check()
    assert got.dim == 4
    twin.commit(sets={twin.gids[0]: twin.vec(4)})
    _, got, moves = twin.check()
    assert got.dim == 4
    assert moves == {"full_builds": 0, "delta_refreshes": 1}


def _coo_source(n=50, dim=6, seed=9):
    rng = np.random.default_rng(seed)
    vectors = rng.standard_normal((n, dim)).astype(np.float32)
    src, dst = rng.integers(0, n, 200), rng.integers(0, n, 200)
    return CooSource(src, dst, n, properties={"v": vectors}), vectors, rng


def test_coo_source_property_commits():
    source, vectors, rng = _coo_source()
    new = rng.standard_normal((3, 6)).astype(np.float32)
    changed = source.commit(set_properties={"v": (
        [4, 9, 11, 12], [new[0], None, [1.0, 2.0], new[1].tolist()])})
    assert changed == frozenset({4, 9, 11, 12})
    assert source.changes_between(0, 1) == changed
    got = source.vertex_property("v", [4, 9, 11, 12, 13])
    # the list form: rows as lists, a value of another length as given
    assert got == [new[0].tolist(), None, [1.0, 2.0], new[1].tolist(),
                   vectors[13].tolist()]
    assert np.array_equal(source.vertex_property("v", [1, 2]), vectors[1:3])
    # values that fit went into the rows: a read without the others is
    # the rows' array
    read = source.vertex_property("v", [4, 12, 13])
    assert isinstance(read, np.ndarray) and read.dtype == np.float32
    assert np.array_equal(read, np.stack([new[0], new[1], vectors[13]]))
    # a property only commits set, on a vertex a commit added
    source.commit(add_vertices=1, set_properties={"w": ([50], [[3.0]])})
    assert source.vertex_property("w", [0, 50]) == [None, [3.0]]
    assert source.vertex_property("v", [50]) == [None]
    with pytest.raises(ValueError):
        source.commit(set_properties={"v": ([51], [None])})
    with pytest.raises(ValueError):
        source.commit(set_properties={"v": ([1, 2], [None])})


def test_a_delta_refresh_of_a_coo_source_equals_a_full_build():
    source, vectors, rng = _coo_source()
    cache = VS.IndexCache()
    first = cache.get(source, "v", "cpu")
    kept = first.matrix.clone(), first.valid.clone(), list(first.row_gids)
    source.commit(set_properties={"v": (
        [1, 2, 3, 7], [rng.standard_normal(6).astype(np.float32), None,
                       [0.5] * 4, rng.standard_normal(6).tolist()])})
    cache.get(source, "v", "cpu")
    source.commit(add_vertices=2, set_properties={"v": (
        [50, 51, 2], [rng.standard_normal(6).astype(np.float32),
                      rng.standard_normal(6).tolist(),
                      rng.standard_normal(6).astype(np.float32)])})
    got = cache.get(source, "v", "cpu")
    assert cache.counters == {"full_builds": 1, "delta_refreshes": 2}
    # the first version's readers keep their rows
    assert torch.equal(first.matrix, kept[0])
    assert torch.equal(first.valid, kept[1]) and first.row_gids == kept[2]
    full = VS.full_build(source, "v", "cpu")
    assert set(got.gid_to_row) == set(full.gid_to_row)
    assert got.dim_counts == full.dim_counts and got.offdim == full.offdim
    for gid, row in full.gid_to_row.items():
        assert torch.equal(got.matrix[got.gid_to_row[gid]], full.matrix[row])
    live = [r for r, g in enumerate(got.row_gids) if g is not None]
    assert torch.equal(torch.nonzero(got.valid).flatten(),
                       torch.as_tensor(live))
    q = rng.standard_normal(6).tolist()
    a = VS.search(source, "v", q, 10, index_cache=cache, device="cpu")
    b = VS.search(source, "v", q, 10, index_cache=VS.IndexCache(),
                  device="cpu")
    assert a["node_gids"].tolist() == b["node_gids"].tolist()
    assert np.array_equal(a["similarity"], b["similarity"])


def test_coo_source_keeps_what_does_not_fit_its_rows_as_given():
    source, vectors, rng = _coo_source()
    caller = vectors.copy()
    near = rng.standard_normal(6).tolist()          # not float32-exact
    ints = [1, 2, 3, 4, 5, 6]                       # another kind
    source.commit(add_vertices=1, set_properties={"v": (
        [0, 1, 2, 3, 50], [near, ints, [True] * 6, None, vectors[7]])})
    # the caller's array is not written
    assert np.array_equal(vectors, caller)
    got = source.vertex_property("v", [0, 1, 2, 3, 50, 5])
    assert got[0] is near and got[1] is ints and got[2] == [True] * 6
    assert got[3] is None
    assert got[4] == vectors[7].tolist() and got[5] == vectors[5].tolist()
    # the rows a full build keeps are the same in either form
    matrix, kept = property_rows(got)
    assert kept.tolist() == [True, True, False, False, True, True]
    assert np.array_equal(matrix[:2], np.float32([near, ints]))
    # a vertex set again with a fitting value goes back into the rows
    source.commit(set_properties={"v": ([0], [vectors[0]])})
    assert np.array_equal(source.vertex_property("v", [0, 50]),
                          vectors[[0, 7]])
