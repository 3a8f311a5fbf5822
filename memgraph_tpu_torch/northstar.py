"""The north-star graph, its commits and the versioned source they go
through, made from seeds.

``generate_graph``: a skewed random digraph (heavy-tail in-degree by
squared sampling of destinations), 1,000,000 nodes and 10,000,000 edges
from seed 7 (``GRAPH_SEED``), as ``bench.py`` builds it.  ``mutation``:
the commit that a snapshot refresh serves (seed 11);
``second_commit``: the one after it (seed 13).  ``vector_corpus`` and
``node_labels``: the nodes' seeded embedding vectors and classes (the
dense paths' property data).  ``CooSource``: a
versioned COO graph with a bounded change log, the source (ops/csr.py)
that ``GraphCache`` snapshots.  Used by ``chip_smoke.py`` and
``trace_pagerank``.
"""

from __future__ import annotations

import threading
from collections import deque

import numpy as np

from .ops.csr import ChangeLogUnknowable

N_NODES = 1_000_000
N_EDGES = 10_000_000
GRAPH_SEED = 7
REFRESH_SEED = 11
REFRESH_MOVES = 5_000        # edges removed uniformly, and edges added
REFRESH_NODES = 8            # nodes made dangling, and dangling nodes fed


def generate_graph(n_nodes=N_NODES, n_edges=N_EDGES):
    """(src, dst) int64: src uniform, dst = rand**2 * n."""
    rng = np.random.default_rng(GRAPH_SEED)
    src = rng.integers(0, n_nodes, n_edges, dtype=np.int64)
    dst = (rng.random(n_edges) ** 2 * n_nodes).astype(np.int64)
    return src, dst


def mutation(src, dst, n_nodes):
    """The refresh mutation, from ``REFRESH_SEED``: remove
    ``REFRESH_MOVES`` existing edges drawn uniformly, add as many edges
    (src uniform, dst from the graph's own skew rand**2 * n), remove every
    out-edge of ``REFRESH_NODES`` nodes (they become dangling) and add one
    out-edge to each of as many nodes that had none.  Returns (the mask of
    the edges removed, added src, added dst)."""
    rng = np.random.default_rng(REFRESH_SEED)
    moves, nodes = REFRESH_MOVES, REFRESH_NODES
    E = len(src)
    out_deg = np.bincount(src, minlength=n_nodes)
    drop = np.zeros(E, dtype=bool)
    drop[rng.choice(E, moves, replace=False)] = True
    emptied = rng.choice(np.flatnonzero(out_deg > 0), nodes, replace=False)
    drop |= np.isin(src, emptied)
    fed = rng.choice(np.flatnonzero(out_deg == 0), nodes, replace=False)
    add_src = np.concatenate([rng.integers(0, n_nodes, moves), fed])
    add_dst = np.concatenate([
        (rng.random(moves) ** 2 * n_nodes).astype(np.int64),
        rng.integers(0, n_nodes, nodes)])
    return drop, add_src, add_dst


SECOND_SEED = 13
SECOND_MOVES = 1_000         # edges removed uniformly, and edges added


def second_commit(alive_ids, n_nodes):
    """The commit after the refresh mutation, from ``SECOND_SEED``: the
    ids of ``SECOND_MOVES`` edges drawn uniformly from ``alive_ids`` to
    remove, and as many edges to add (src uniform, dst on the graph's
    skew).  Returns (removed ids, added src, added dst)."""
    rng = np.random.default_rng(SECOND_SEED)
    removed = rng.choice(alive_ids, SECOND_MOVES, replace=False)
    add_src = rng.integers(0, n_nodes, SECOND_MOVES)
    add_dst = (rng.random(SECOND_MOVES) ** 2 * n_nodes).astype(np.int64)
    return removed, add_src, add_dst


VECTOR_DIM = 128             # ann-benchmarks' sift-128-euclidean width
VECTOR_BLOBS = 64
VECTOR_SEED = 19
N_CLASSES = 8
LABEL_SEED = 23


def vector_corpus(n: int = N_NODES, dim: int = VECTOR_DIM,
                  blobs: int = VECTOR_BLOBS):
    """(points (n, dim) f32, the blob of each point), from
    ``VECTOR_SEED``: well-separated Gaussian blobs, centers N(0, 4²) a
    coordinate (about 64 apart), points their center + N(0, 1) (about
    11 from it)."""
    rng = np.random.default_rng(VECTOR_SEED)
    centers = rng.standard_normal((blobs, dim), dtype=np.float32) * 4
    blob = rng.integers(0, blobs, n)
    points = centers[blob] + rng.standard_normal((n, dim), dtype=np.float32)
    return points, blob


def node_labels(n: int = N_NODES) -> np.ndarray:
    """A class in [0, N_CLASSES) for each node, from ``LABEL_SEED``."""
    return np.random.default_rng(LABEL_SEED).integers(0, N_CLASSES, n)


def _fits(rows: np.ndarray, value) -> bool:
    """Whether ``value`` is a numeric value of the kind and shape of a row
    of ``rows`` that the cast keeps exactly."""
    try:
        v = np.asarray(value)
    except ValueError:           # a ragged value
        return False
    return (v.dtype.kind in "iuf" and v.dtype.kind == rows.dtype.kind
            and v.shape == rows.shape[1:]
            and bool(np.array_equal(v.astype(rows.dtype), v)))


class CooSource:
    """A versioned COO graph with a bounded change log: a source of
    ``ops.csr.GraphCache`` (see ops/csr.py) that keeps the storage's
    contract without a storage.

    Vertices are gids 0..n_nodes-1, then those ``commit`` adds.  Edges
    have ids in commit order (the first ``len(src)`` are the initial
    ones) and one property, ``WEIGHT``; there are no labels and one edge
    type, so only ``label_filter=None`` and ``edge_type_filter=None`` are
    answered.  Each ``commit`` is one version whose change-log entry
    holds the gids of every vertex it touched (an edge's two endpoints, a
    new vertex); ``untracked_bump`` is a version that records none.
    ``properties`` gives the initial vertices their vertex properties (a
    name and an array with a value, or a row, for each), which
    ``vertex_property`` reads; the vertices that commits add have none
    until a commit sets one (``set_properties``, logged as a change of
    each vertex it sets, as the storage logs a property write).  A value
    a commit sets goes into the property's array (this source's own
    copy) where it fits there exactly: a numeric value of the same kind
    and shape as the array's rows, equal after the cast; any other value
    is kept as it was given.  A read is the array's rows when every
    vertex read holds one, else a list: a row as a list, a scalar as
    itself, a kept value as given, None where the vertex has none.  The
    log keeps the last ``log_size`` entries behind a monotone low-water
    mark, and ``changes_between`` answers as the storage's does: the
    union of the entries in (v_from, v_to], or ``ChangeLogUnknowable``
    ("log_wrapped" past the mark, "untracked_bump")."""

    WEIGHT = "weight"

    def __init__(self, src, dst, n_nodes: int, weights=None,
                 log_size: int = 1024, properties=None) -> None:
        self.storage = self
        # vertex properties: name -> an array with a value (a row) for
        # each initial vertex
        self._props = {k: np.asarray(v) for k, v in (properties or {}).items()}
        # from a property's first write: whether each vertex holds a row
        # (the array is then this source's copy, grown to every vertex)
        self._prop_held: dict = {}
        # values set by commits that do not fit the array: {gid: value}
        self._prop_odd: dict = {}
        if any(len(v) != n_nodes for v in self._props.values()):
            raise ValueError("a vertex property needs one value a vertex")
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if len(src) and (min(src.min(), dst.min()) < 0
                         or max(src.max(), dst.max()) >= n_nodes):
            raise ValueError(f"an edge endpoint is outside [0, {n_nodes})")
        self._n0 = int(n_nodes)
        self._n = int(n_nodes)
        # the initial edges, indexed once by src and by dst (edge ids in
        # order within a vertex), then the appended ones
        self._base = (src, dst, np.ones(len(src), dtype=np.float32)
                      if weights is None
                      else np.array(weights, dtype=np.float32))
        self._base_alive = np.ones(len(src), dtype=bool)
        self._index = tuple(self._by_vertex(k, self._n0) for k in (src, dst))
        self._app = (np.zeros(0, np.int64), np.zeros(0, np.int64),
                     np.zeros(0, np.float32))
        self._app_alive = np.zeros(0, dtype=bool)
        self._version = 0
        self.log_size = log_size
        self._log = deque(maxlen=log_size)
        self._oldest_logged_version = 1
        self._log_lock = threading.Lock()

    @staticmethod
    def _by_vertex(keys, n):
        order = np.argsort(keys, kind="stable")
        ptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(keys, minlength=n), out=ptr[1:])
        return ptr, order

    # --- the source ---------------------------------------------------------

    @property
    def version(self) -> int:
        return self._version

    @property
    def oldest_logged_version(self) -> int:
        return self._oldest_logged_version

    def changes_between(self, v_from: int, v_to: int):
        if v_from == v_to:
            return frozenset()
        with self._log_lock:
            entries = list(self._log)
            oldest = self._oldest_logged_version
        if v_from + 1 < oldest or not entries:
            return ChangeLogUnknowable("log_wrapped", oldest)
        out: set = set()
        for version, gids in entries:
            if version <= v_from or version > v_to:
                continue
            if gids is None:
                return ChangeLogUnknowable("untracked_bump", oldest)
            out |= gids
        return frozenset(out)

    def vertices(self, label_filter=None):
        self._no_filters(label_filter, None)
        return np.arange(self._n, dtype=np.int64)

    def edges(self, weight_property=None, edge_type_filter=None):
        self._no_filters(None, edge_type_filter)
        (bs, bd, bw), (as_, ad, aw) = self._base, self._app
        ba, aa = self._base_alive, self._app_alive
        src = np.concatenate([bs[ba], as_[aa]])
        dst = np.concatenate([bd[ba], ad[aa]])
        w = (np.concatenate([bw[ba], aw[aa]])
             if self._weighted(weight_property) else None)
        return src, dst, w

    def incident(self, gid, weight_property=None, edge_type_filter=None,
                 label_filter=None):
        self._no_filters(label_filter, edge_type_filter)
        if not 0 <= gid < self._n:
            return None
        weighted = self._weighted(weight_property)
        out = []
        for side in (0, 1):
            ends = self.edge_arrays(self._incident_ids(gid, side))
            out += [ends[1 - side], ends[2] if weighted else None]
        return tuple(out)

    def edge_keys(self):
        """(edge ids, type ids) of the current edges, in ``edges``' order
        (one edge type: 0), for the columnar edge table."""
        ids = self.alive_ids()
        return ids, np.zeros(len(ids), dtype=np.int32)

    def vertex_property(self, name, gids):
        rows = self._props.get(name)
        odd = self._prop_odd.get(name, {})
        if rows is None and not odd:
            return None
        gids = np.asarray(gids, dtype=np.int64)
        dense = np.zeros(len(gids), dtype=bool)
        if rows is not None:
            dense = (gids >= 0) & (gids < len(rows))
            held = self._prop_held.get(name)
            if held is not None:
                dense[dense] = held[gids[dense]]
            if dense.all():
                return rows[gids]
        out = [None] * len(gids)
        for i, row in zip(np.flatnonzero(dense).tolist(),
                          rows[gids[dense]].tolist() if dense.any() else ()):
            out[i] = row
        for i, g in enumerate(gids.tolist()):
            if g in odd:
                out[i] = odd[g]
        return out

    def vertex_records(self, gids):
        """(label names, {property name: value}) of each vertex with a gid
        in ``gids`` (None where it is not in the graph): no labels, and
        the properties a vertex holds, numpy values as python ones."""
        gids = np.asarray(gids, dtype=np.int64)
        out = [None if not 0 <= g < self._n else ([], {})
               for g in gids.tolist()]
        for name in sorted(set(self._props) | set(self._prop_odd)):
            vals = self.vertex_property(name, gids)
            if isinstance(vals, np.ndarray):
                vals = vals.tolist()
            for rec, v in zip(out, vals):
                if rec is not None and v is not None:
                    rec[1][name] = v.tolist() if isinstance(
                        v, (np.ndarray, np.generic)) else v
        return out

    def _set_property(self, name, gid: int, value) -> None:
        """``name`` of vertex ``gid`` set to ``value`` (None: cleared)."""
        odd = self._prop_odd.setdefault(name, {})
        odd.pop(gid, None)
        rows = self._props.get(name)
        if rows is not None:
            held = self._prop_held.get(name)
            if held is None or len(held) < self._n:
                grown = np.zeros((self._n, *rows.shape[1:]), rows.dtype)
                grown[:len(rows)] = rows
                now = np.zeros(self._n, dtype=bool)
                now[:len(rows)] = True if held is None else held
                self._props[name] = rows = grown
                self._prop_held[name] = held = now
            held[gid] = False
            if value is not None and _fits(rows, value):
                rows[gid] = value
                held[gid] = True
                return
        if value is not None:
            odd[gid] = value

    # --- commits --------------------------------------------------------------

    def alive_ids(self) -> np.ndarray:
        """The ids of the edges the current version holds, in order."""
        return np.concatenate([
            np.flatnonzero(self._base_alive),
            len(self._base_alive) + np.flatnonzero(self._app_alive)])

    def edge_arrays(self, ids):
        """(src, dst, weight) of the edges with these ids."""
        ids = np.asarray(ids, dtype=np.int64)
        n0 = len(self._base_alive)
        base, app = ids[ids < n0], ids[ids >= n0] - n0
        return tuple(np.concatenate([b[base], a[app]])
                     for b, a in zip(self._base, self._app))

    def commit(self, add_src=(), add_dst=(), add_weights=None,
               remove=(), set_weights=None, add_vertices: int = 0,
               set_properties=None):
        """One version: remove the edges with ids ``remove``, set the
        weights of ``set_weights = (ids, values)``, add ``add_vertices``
        vertices, then the edges (add_src, add_dst) with ``add_weights``
        (1.0 when None), then the vertex properties of ``set_properties =
        {name: (gids, values)}`` (a value of None clears the property).
        Returns the gids it logged as changed."""
        remove = np.asarray(remove, dtype=np.int64)
        add_src = np.asarray(add_src, dtype=np.int64)
        add_dst = np.asarray(add_dst, dtype=np.int64)
        n0 = len(self._base_alive)
        touched = [remove]
        if len(remove):
            if not self._alive(remove).all():
                raise ValueError("commit removes an edge that is not there")
            self._base_alive[remove[remove < n0]] = False
            self._app_alive[remove[remove >= n0] - n0] = False
        if set_weights is not None:
            ids, values = (np.asarray(v) for v in set_weights)
            ids = ids.astype(np.int64)
            if not self._alive(ids).all():
                raise ValueError("commit sets the weight of an edge that is "
                                 "not there")
            self._base[2][ids[ids < n0]] = values[ids < n0]
            self._app[2][ids[ids >= n0] - n0] = values[ids >= n0]
            touched.append(ids)
        new_gids = np.arange(self._n, self._n + add_vertices, dtype=np.int64)
        self._n += int(add_vertices)
        if len(add_src):
            if (min(add_src.min(), add_dst.min()) < 0
                    or max(add_src.max(), add_dst.max()) >= self._n):
                raise ValueError("commit adds an edge to a vertex that is "
                                 "not there")
            w = (np.ones(len(add_src), np.float32) if add_weights is None
                 else np.asarray(add_weights, dtype=np.float32))
            self._app = tuple(np.concatenate([a, b]) for a, b in
                              zip(self._app, (add_src, add_dst, w)))
            self._app_alive = np.concatenate(
                [self._app_alive, np.ones(len(add_src), dtype=bool)])
        set_gids = []
        for name, (gids, values) in (set_properties or {}).items():
            gids = np.asarray(gids, dtype=np.int64).reshape(-1)
            if len(gids) != len(values):
                raise ValueError("set_properties needs a value a gid")
            if len(gids) and (gids.min() < 0 or gids.max() >= self._n):
                raise ValueError("commit sets a property of a vertex that "
                                 "is not there")
            for gid, value in zip(gids.tolist(), values):
                self._set_property(name, gid, value)
            set_gids.append(gids)
        ends = self.edge_arrays(np.concatenate(touched))
        changed = frozenset(np.concatenate(
            [ends[0], ends[1], add_src, add_dst, new_gids,
             *set_gids]).tolist())
        self._bump(changed)
        return changed

    def untracked_bump(self) -> None:
        """A version whose change-log entry records no gids."""
        self._bump(None)

    # --- internals ------------------------------------------------------------

    def _bump(self, changed) -> None:
        with self._log_lock:
            self._version += 1
            if len(self._log) == self._log.maxlen:
                # the append drops the oldest entry: raise the low-water
                # mark first
                self._oldest_logged_version = self._log[0][0] + 1
            self._log.append((self._version, changed))

    def _alive(self, ids):
        n0 = len(self._base_alive)
        ok = (ids >= 0) & (ids < n0 + len(self._app_alive))
        alive = np.zeros(len(ids), dtype=bool)
        base = ok & (ids < n0)
        alive[base] = self._base_alive[ids[base]]
        app = ok & (ids >= n0)
        alive[app] = self._app_alive[ids[app] - n0]
        return alive

    def _incident_ids(self, gid, side):
        """The ids of the live edges with ``gid`` as src (side 0) or dst
        (side 1), in id order."""
        ptr, order = self._index[side]
        ids = (order[ptr[gid]:ptr[gid + 1]] if gid < self._n0
               else np.zeros(0, np.int64))
        ids = ids[self._base_alive[ids]]
        app = np.flatnonzero((self._app[side] == gid) & self._app_alive)
        return np.concatenate([ids, len(self._base_alive) + app])

    def _weighted(self, weight_property) -> bool:
        if weight_property not in (None, self.WEIGHT):
            raise ValueError(f"a CooSource's edges carry {self.WEIGHT!r} "
                             f"only, not {weight_property!r}")
        return weight_property is not None

    @staticmethod
    def _no_filters(label_filter, edge_type_filter):
        if label_filter is not None or edge_type_filter is not None:
            raise ValueError("a CooSource has no labels and one edge type: "
                             "it answers no label or edge-type filter")
