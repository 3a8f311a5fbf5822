"""Host results of the vector procedures, from an index snapshot.

Port of the compute half of memgraph_tpu/procedures/vector_search.py
(``vector_search.search``, ``knn.get``, ``vector_search.ppr_search``).
An index snapshot holds the embedding rows of one vertex property at one
topology version: the matrix on the device, ``valid`` (1.0 a live row)
and ``row_gids`` (the gid of each row, None for a freed one).  It is
built in full from a source (ops/csr.py, ``vertex_property``) by the
reference's rules: every visible vertex whose value is a non-empty list
of numbers is a candidate, and the rows are the candidates of the
dominant dimension (the most frequent length; the first seen on a tie),
in the source's vertex order.  ``IndexCache`` keeps the newest
snapshots of each storage and property; a version whose change log
records no changed vertex since the newest older snapshot aliases it.
Each function takes a source, the procedure's arguments with its
defaults, the caches and the ``device``, and returns what the procedure
yields as host numpy columns by gid (``node_gids``), a row a record.

Left out: the index's delta refresh (``_delta_refresh``: an index after
a commit rebuilds in full here) and the kernel-server leg of
``ppr_search``.
"""

from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..ops.csr import GLOBAL_GRAPH_CACHE, property_rows
from ..ops.knn import knn
from ..ops.pagerank import personalized_pagerank

_KEEP_VERSIONS = 4          # concurrent readers at older snapshots


@dataclass
class IndexSnapshot:
    """The embedding rows of one property at one version."""
    version: int
    dim: int | None                      # dominant dimension (rows kept)
    row_gids: list = field(default_factory=list)   # row -> gid | None
    gid_to_row: dict = field(default_factory=dict)
    matrix: object = None                # (rows, dim) f32 on the device
    valid: object = None                 # (rows,) f32 on the device

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
    if mat is None:
        return IndexSnapshot(version, None)
    row_gids = gids[kept].tolist()
    return IndexSnapshot(
        version, mat.shape[1], row_gids=row_gids,
        gid_to_row={g: i for i, g in enumerate(row_gids)},
        matrix=torch.from_numpy(mat).to(dev),
        valid=torch.ones(len(row_gids), dtype=torch.float32, device=dev))


class IndexCache:
    """Index snapshots by storage (weakly), property, device and version;
    the newest ``_KEEP_VERSIONS`` versions of each are kept.
    ``counters["full_builds"]`` counts the snapshots built."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cache = weakref.WeakKeyDictionary()
        self.counters = {"full_builds": 0}

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
            # nothing changed since the newest older snapshot: alias it
            parent = held[max(older)]
            changed = source.changes_between(parent.version, version)
            if isinstance(changed, frozenset) and not changed:
                entry = parent
        if entry is None:
            entry = full_build(source, property_name, dev)
        with self._lock:
            per = self._cache.get(source.storage)
            if per is None:
                per = self._cache[source.storage] = {}
            by_version = per.setdefault(key, {})
            by_version[version] = entry
            for v in sorted(by_version)[:-_KEEP_VERSIONS]:
                del by_version[v]
            if entry.version == version:
                self.counters["full_builds"] += 1
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
               index_cache=GLOBAL_INDEX_CACHE, device=None) -> dict:
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
    ranks, _, _ = personalized_pagerank(graph, seeds, damping=float(damping),
                                        max_iterations=100)
    ranks = ranks.cpu().numpy()
    order = np.argsort(-ranks)[:int(limit)]
    order = order[ranks[order] > 0]
    return {"node_gids": np.asarray(graph.node_gids, dtype=np.int64)[order],
            "score": ranks[order],
            "seed_similarity": np.asarray([seed_sim.get(int(i), 0.0)
                                           for i in order])}

