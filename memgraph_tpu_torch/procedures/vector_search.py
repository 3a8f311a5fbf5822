"""Host results of the vector procedures, from an index snapshot.

Port of the compute half of memgraph_tpu/procedures/vector_search.py
(``vector_search.search``, ``knn.get``, ``vector_search.ppr_search``)
and of its index maintenance.  An index snapshot holds the embedding
rows of one vertex property at one topology version: the matrix on the
device, ``valid`` (1.0 a live row), ``row_gids`` (the gid of each row,
None for a freed one), the freed rows, the count of candidates of each
dimension (``dim_counts``) and the dimension of each candidate of
another one than the rows' (``offdim``).  A full build reads the
property of every vertex of a source (ops/csr.py, ``vertex_property``)
by the reference's rules: every visible vertex whose value is a
non-empty list of numbers is a candidate, and the rows are the
candidates of the dominant dimension (the most frequent length; the
first seen on a tie), in the source's vertex order.

``IndexCache`` keeps the newest snapshots of each storage and property.
A newer version comes from the newest older snapshot as the reference's
``_get_index`` chooses: that snapshot itself when the change log records
no changed vertex since; a delta refresh (``_delta_refresh``) when at
most max(64, half the snapshot's size) vertices changed, which reads the
changed vertices' values only, retires their old rows (freed rows are
reused last in, first out; the matrix grows by max(16, its rows)) and
writes their new ones on the device, clears before sets; a full build
when the log cannot say what changed, when more changed, or when the
dominant dimension flips.  Each function takes a source, the procedure's
arguments with its defaults, the caches and the ``device``, and returns
what the procedure yields as host numpy columns by gid (``node_gids``),
a row a record.

``ppr_search`` takes the kernel server's coalescing plane for its PPR
leg when ``kernel=`` (or ``MEMGRAPH_TPU_ANALYTICS_KERNEL_SERVER``) names
a daemon (procedures/graph_algorithms.py ``_kernel_server_ppr``): one
round trip, the top ``limit`` extracted on the card; a failure falls
back to the in-process leg, loudly.

Left out: the private entry
the reference serves a transaction with writes of its own (the port's
source has no transaction; that waits for the Cypher layer).  The
reference's delta refresh reads a property that was unknown at its
parent's full build as unset; here it reads it, and a value found there
gives a full build.
"""

from __future__ import annotations

import threading
import weakref
from collections import Counter
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..ops.csr import (GLOBAL_GRAPH_CACHE, ChangeLogUnknowable,
                       _numeric_list, property_rows)
from ..ops.knn import knn
from ..ops.pagerank import personalized_pagerank
from .graph_algorithms import _kernel_server_ppr

_KEEP_VERSIONS = 4          # concurrent readers at older snapshots
_DELTA_MAX_FRACTION = 0.5   # larger deltas rebuild outright


@dataclass
class IndexSnapshot:
    """The embedding rows of one property at one version."""
    version: int
    dim: int | None                      # dominant dimension (rows kept)
    dim_counts: Counter = field(default_factory=Counter)  # per dimension
    row_gids: list = field(default_factory=list)   # row -> gid | None
    gid_to_row: dict = field(default_factory=dict)
    free_rows: list = field(default_factory=list)
    offdim: dict = field(default_factory=dict)     # gid -> other dim
    matrix: object = None                # (capacity, dim) f32 on the device
    valid: object = None                 # (capacity,) f32 on the device

    @property
    def size(self) -> int:
        return len(self.gid_to_row)


def full_build(source, property_name: str, device=None) -> IndexSnapshot:
    """The index snapshot of ``property_name`` at the source's version,
    every row live, on ``device`` (default: the card)."""
    dev = resolve_device(device)
    version = source.version
    gids = np.asarray(list(source.vertices()), dtype=np.int64)
    values = source.vertex_property(property_name, gids) if len(gids) \
        else None
    if values is None:
        return IndexSnapshot(version, None)
    mat, kept = property_rows(values)
    # each candidate's dimension, in gid order (a tie of the counts goes
    # to the first seen); the other dimensions' are among the values not
    # kept
    lengths = np.zeros(len(kept), dtype=np.int64)
    if mat is not None:
        lengths[kept] = mat.shape[1]
    for i in np.flatnonzero(~kept).tolist():
        vec = _numeric_list(values[i])
        if vec is not None:
            lengths[i] = len(vec)
    dim_counts = Counter(lengths[lengths > 0].tolist())
    if mat is None:
        return IndexSnapshot(version, None, dim_counts)
    dim = mat.shape[1]
    row_gids = gids[kept].tolist()
    off = (lengths > 0) & ~kept
    return IndexSnapshot(
        version, dim, dim_counts, row_gids=row_gids,
        gid_to_row={g: i for i, g in enumerate(row_gids)},
        offdim=dict(zip(gids[off].tolist(), lengths[off].tolist())),
        matrix=torch.from_numpy(mat).to(dev),
        valid=torch.ones(len(row_gids), dtype=torch.float32, device=dev))


def _delta_refresh(source, property_name: str, parent: IndexSnapshot,
                   changed, version: int):
    """The snapshot at ``version`` from ``parent``, patched at the
    ``changed`` gids only, or None when a full build is needed (the
    dominant dimension flipped, or a parent without rows sees
    candidates)."""
    dim_counts = Counter(parent.dim_counts)
    gid_to_row = dict(parent.gid_to_row)
    row_gids = list(parent.row_gids)
    free_rows = list(parent.free_rows)
    offdim = dict(parent.offdim)
    set_rows: list[int] = []
    set_vals: list = []
    clear_rows: list[int] = []
    new_vecs: dict = {}

    def drop_row(gid):
        row = gid_to_row.pop(gid, None)
        if row is not None:
            row_gids[row] = None
            free_rows.append(row)
            clear_rows.append(row)

    changed = list(changed)
    values = source.vertex_property(property_name, changed) if changed \
        else None
    for i, gid in enumerate(changed):
        vec = None if values is None else _numeric_list(values[i])
        # retire the gid's previous candidate (row or off-dimension)
        if gid in gid_to_row:
            dim_counts[parent.dim] -= 1
        elif gid in offdim:
            dim_counts[offdim.pop(gid)] -= 1
        if vec is None:
            drop_row(gid)
        elif parent.dim is not None and len(vec) == parent.dim:
            dim_counts[parent.dim] += 1
            new_vecs[gid] = vec
        else:
            # an off-dimension candidate: counted (dominance tracking)
            # but holds no row
            dim_counts[len(vec)] += 1
            offdim[gid] = len(vec)
            drop_row(gid)

    dim_counts = Counter({d: c for d, c in dim_counts.items() if c > 0})
    if parent.dim is None:
        return None if dim_counts else IndexSnapshot(version, None,
                                                     dim_counts)
    if dim_counts and dim_counts.most_common(1)[0][0] != parent.dim:
        return None                      # dominant dimension flipped

    matrix, valid = parent.matrix, parent.valid
    for gid, vec in new_vecs.items():
        row = gid_to_row.get(gid)
        if row is None:
            if free_rows:
                row = free_rows.pop()
            else:
                row = len(row_gids)
                row_gids.append(None)
                if row >= matrix.shape[0]:
                    grow = max(16, matrix.shape[0])
                    matrix = torch.cat([matrix, matrix.new_zeros(
                        (grow, parent.dim))])
                    valid = torch.cat([valid, valid.new_zeros(grow)])
            gid_to_row[gid] = row
            row_gids[row] = gid
        set_rows.append(row)
        set_vals.append(vec)

    if (clear_rows or set_rows) and matrix is parent.matrix:
        # the parent's tensors stay as they were for its readers
        matrix, valid = matrix.clone(), valid.clone()
    dev = matrix.device
    # clears before sets: a freed row reused in this refresh ends valid
    if clear_rows:
        valid[torch.as_tensor(clear_rows, dtype=torch.long,
                              device=dev)] = 0.0
    if set_rows:
        rows = torch.as_tensor(set_rows, dtype=torch.long, device=dev)
        matrix.index_copy_(0, rows, torch.from_numpy(
            np.asarray(set_vals, dtype=np.float32)).to(dev))
        valid[rows] = 1.0
    return IndexSnapshot(version, parent.dim, dim_counts,
                         row_gids=row_gids, gid_to_row=gid_to_row,
                         free_rows=free_rows, offdim=offdim,
                         matrix=matrix, valid=valid)


class IndexCache:
    """Index snapshots by storage (weakly), property, device and version;
    the newest ``_KEEP_VERSIONS`` versions of each are kept.
    ``counters``: "full_builds" and "delta_refreshes", the snapshots made
    each way (an alias of an older snapshot counts in neither, nor does a
    new version of an index without rows)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cache = weakref.WeakKeyDictionary()
        self.counters = {"full_builds": 0, "delta_refreshes": 0}

    def get(self, source, property_name: str, device=None) -> IndexSnapshot:
        dev = resolve_device(device)
        version = source.version
        key = (property_name, dev)
        with self._lock:
            held = dict((self._cache.get(source.storage) or {}).get(key)
                        or {})
        if version in held:
            return held[version]
        older = [v for v in held if v < version]
        entry = None
        if older:
            parent = held[max(older)]
            changed = source.changes_between(parent.version, version)
            if isinstance(changed, ChangeLogUnknowable):
                changed = None       # the gap cannot be rebuilt: in full
            if changed is not None and not changed:
                entry = parent       # nothing changed: alias the parent
            elif changed is not None and (
                    parent.size == 0 or len(changed) <= max(
                        64, _DELTA_MAX_FRACTION * parent.size)):
                # iterated as the reference iterates its union with the
                # transaction's own writes (none here): the order fixes
                # the rows new vectors take
                entry = _delta_refresh(source, property_name, parent,
                                       changed | frozenset(), version)
                # counted as the reference counts: an index without rows
                # that stays so is no refresh
                if entry is not None and entry.dim is not None:
                    with self._lock:
                        self.counters["delta_refreshes"] += 1
        if entry is None:
            entry = full_build(source, property_name, dev)
            with self._lock:
                self.counters["full_builds"] += 1
        with self._lock:
            per = self._cache.get(source.storage)
            if per is None:
                per = self._cache[source.storage] = {}
            by_version = per.setdefault(key, {})
            by_version[version] = entry
            for v in sorted(by_version)[:-_KEEP_VERSIONS]:
                del by_version[v]
        return entry


GLOBAL_INDEX_CACHE = IndexCache()


def _search_entry(entry: IndexSnapshot, query_rows, k: int, metric: str):
    """(scores (q, k'), row indices (q, k')) over the live rows, as host
    arrays, or (None, None) when there is nothing to search."""
    k = min(k, entry.size)
    if k <= 0 or entry.matrix is None:
        return None, None
    scores, idx = knn(entry.matrix, query_rows, k=k, metric=metric,
                      valid_mask=entry.valid)
    return scores.cpu().numpy(), idx.cpu().numpy()


def _query(entry: IndexSnapshot, query):
    return torch.as_tensor(np.asarray([query], dtype=np.float32)).to(
        entry.matrix.device)


def _none(*fields) -> dict:
    return {"node_gids": np.zeros(0, dtype=np.int64),
            **{f: np.zeros(0) for f in fields}}


def search(source, property, query, limit, metric="cosine", *,
           index_cache=GLOBAL_INDEX_CACHE, device=None) -> dict:
    """``vector_search.search``: node, similarity — the ``limit`` rows
    nearest ``query`` (bf16 scores, as the reference's)."""
    entry = index_cache.get(source, property, device)
    if entry.matrix is None:
        return _none("similarity")
    scores, idx = _search_entry(entry, _query(entry, query), int(limit),
                                str(metric))
    if scores is None:
        return _none("similarity")
    gids, sims = [], []
    for score, i in zip(scores[0], idx[0]):
        gid = entry.row_gids[int(i)]
        if gid is not None:
            gids.append(gid)
            sims.append(score)
    return {"node_gids": np.asarray(gids, dtype=np.int64),
            "similarity": np.asarray(sims, dtype=np.float32)}


def knn_get(source, node, property, k, metric="cosine", *,
            index_cache=GLOBAL_INDEX_CACHE, device=None) -> dict:
    """``knn.get``: neighbor, similarity — the k rows nearest the vertex
    with gid ``node`` (its own row skipped)."""
    entry = index_cache.get(source, property, device)
    row = entry.gid_to_row.get(node) if node is not None else None
    if entry.matrix is None or row is None:
        return _none("similarity")
    scores, idx = _search_entry(entry, entry.matrix[row:row + 1],
                                int(k) + 1, str(metric))
    if scores is None:
        return _none("similarity")
    gids, sims = [], []
    for score, i in zip(scores[0], idx[0]):
        if int(i) == row:
            continue
        if len(gids) >= int(k):
            break
        gid = entry.row_gids[int(i)]
        if gid is not None:
            gids.append(gid)
            sims.append(score)
    return {"node_gids": np.asarray(gids, dtype=np.int64),
            "similarity": np.asarray(sims, dtype=np.float32)}


def ppr_search(source, property, query, k_seeds, limit, damping=0.85,
               metric="cosine", *, cache=GLOBAL_GRAPH_CACHE,
               index_cache=GLOBAL_INDEX_CACHE, device=None,
               kernel=None) -> dict:
    """``vector_search.ppr_search``: node, score, seed_similarity — the
    ``k_seeds`` rows nearest ``query`` seed a personalized PageRank (100
    iterations at most) on the graph's snapshot, whose ``limit``
    highest-ranked nodes with a positive rank are the records."""
    fields = ("score", "seed_similarity")
    entry = index_cache.get(source, str(property), device)
    if entry.matrix is None:
        return _none(*fields)
    graph = cache.get(source, device=device)
    if graph.n_nodes == 0:
        return _none(*fields)
    sims, idx = _search_entry(entry, _query(entry, query), int(k_seeds),
                              str(metric))
    if sims is None:
        return _none(*fields)
    seed_sim: dict[int, float] = {}
    seeds: list[int] = []
    for sim, i in zip(sims[0], idx[0]):
        gid = entry.row_gids[int(i)]
        di = graph.gid_to_idx.get(gid) if gid is not None else None
        if di is not None:
            seeds.append(di)
            seed_sim[di] = float(sim)
    if not seeds:
        return _none(*fields)
    served = _kernel_server_ppr(source, graph, seeds, float(damping), 100,
                                1e-6, kernel, top_k=int(limit))
    if served is not None:
        order, scores = served_topk(served[1])
    else:
        ranks, _, _ = personalized_pagerank(graph, seeds,
                                            damping=float(damping),
                                            max_iterations=100)
        ranks = ranks.cpu().numpy()
        order = np.argsort(-ranks)[:int(limit)]
        order = order[ranks[order] > 0]
        scores = ranks[order]
    return {"node_gids": np.asarray(graph.node_gids, dtype=np.int64)[order],
            "score": scores,
            "seed_similarity": np.asarray([seed_sim.get(int(i), 0.0)
                                           for i in order])}


def served_topk(out):
    """(dense ids, scores) of a PPR reply's top-k, up to its first score
    that is not positive."""
    vals = np.asarray(out["topk_val"])
    stop = np.flatnonzero(vals <= 0)
    n = int(stop[0]) if len(stop) else len(vals)
    return np.asarray(out["topk_idx"][:n], dtype=np.int64), vals[:n]

