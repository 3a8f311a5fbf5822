"""Host results of the graph-algorithm procedures, from a storage
snapshot.

Port of the compute half of memgraph_tpu/procedures/graph_algorithms.py
(``pagerank.get``, ``pagerank.personalized``, ``katz_centrality.get``,
``community_detection.get``, ``weakly_connected_components.get``,
``strongly_connected_components.get``, ``degree_centrality.get``,
``hits.get``, ``bfs.get``, ``sssp.get``, ``graph_util.khop``) and of
memgraph_tpu/procedures/structure_modules.py's
``betweenness_centrality.get`` (the registration that serves).  Each
function takes a source (ops/csr.py), the procedure's arguments with its
defaults, the snapshot ``cache`` and the ``device``; it snapshots the
source's graph through the cache (``GraphCache.get``: delta export and
refresh lineage included) and returns what the procedure yields as host
arrays: ``node_gids`` (int64) and one numpy column per result field, a
row per yielded record.  An empty graph yields no row.  Vertices are
named by gid where the procedure takes nodes.

``pagerank.get``, ``katz_centrality.get``, ``community_detection.get``
and ``weakly_connected_components.get`` consult a warm pool
(``pool=``, ops/delta.py's ``GLOBAL_WARM_POOL`` by default) as the
reference's ``_warm_prepare`` does, with its parameter keys: a repeated
call on an unchanged graph returns the stored host array (the same
bytes, read-only), and a call after a commit seeds the fixpoint (``x0``,
``labels0``, ``comp0``) from the previous answer under the warm-start
contract (WCC and label propagation only over adds-only deltas, else a
counted cold start).  The reference demotes a hit to a warm seed under
PROFILE (its stage accounting); the port has no such accounting, so a
hit is always served as it is.

Left out: the mgp registration and the Cypher surface, and the
kernel-server route.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.betweenness import betweenness_centrality
from ..ops.components import (strongly_connected_components,
                              weakly_connected_components)
from ..ops.csr import GLOBAL_GRAPH_CACHE
from ..ops.delta import GLOBAL_WARM_POOL
from ..ops.katz import degree_centrality, hits, katz_centrality
from ..ops.labelprop import label_propagation
from ..ops.pagerank import pagerank, personalized_pagerank
from ..ops.traversal import bfs_levels, khop_neighborhood, sssp


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rows(graph, select=None, **columns) -> dict:
    """The records: ``node_gids`` and each column, every node's or the
    selected ones'."""
    out = {"node_gids": np.asarray(graph.node_gids, dtype=np.int64)}
    out.update({k: _host(v) for k, v in columns.items()})
    if select is not None:
        out = {k: v[select] for k, v in out.items()}
    return out


def _none(*fields) -> dict:
    """No record."""
    return {"node_gids": np.zeros(0, dtype=np.int64),
            **{f: np.zeros(0) for f in fields}}


def _indices(graph, gids) -> list:
    """The dense indices of the gids the snapshot holds."""
    return [graph.gid_to_idx[g] for g in gids
            if g is not None and g in graph.gid_to_idx]


def _warm(pool, source, graph, algo: str, params_key: tuple, compute):
    """The answer of ``algo`` on ``graph`` through the warm pool: the
    stored host array on a hit (read-only), else ``compute(seed)`` (seed
    None: cold) as a host array, of which the pool stores a copy for the
    next call.  ``compute`` returns (answer, iterations)."""
    version = source.version
    cached, seed = pool.prepare(source, graph, version, algo, params_key)
    if cached is not None:
        return cached
    x, iters = compute(seed)
    x = _host(x)
    pool.store(source, graph, version, algo, params_key, x, iters)
    if seed is not None:
        pool.record_warm_start(algo, iters)
    return x


def pagerank_get(source, max_iterations=100, damping_factor=0.85,
                 stop_epsilon=1e-5, weight_property=None, *,
                 cache=GLOBAL_GRAPH_CACHE, pool=GLOBAL_WARM_POOL,
                 device=None) -> dict:
    """``pagerank.get``: node, rank."""
    graph = cache.get(source, weight_property=weight_property, device=device)
    if graph.n_nodes == 0:
        return _none("rank")

    def compute(x0):
        ranks, _, iters = pagerank(graph, damping=float(damping_factor),
                                   max_iterations=int(max_iterations),
                                   tol=float(stop_epsilon), x0=x0)
        return ranks, iters

    ranks = _warm(pool, source, graph, "pagerank",
                  ("pagerank", float(damping_factor), float(stop_epsilon),
                   int(max_iterations), weight_property), compute)
    return _rows(graph, rank=ranks)


def pagerank_personalized(source, source_nodes, max_iterations=100,
                          damping_factor=0.85, *, cache=GLOBAL_GRAPH_CACHE,
                          device=None) -> dict:
    """``pagerank.personalized``: node, rank, restarting on the vertices
    with gids ``source_nodes`` (those outside the snapshot are dropped;
    none left: no record)."""
    graph = cache.get(source, device=device)
    sources = _indices(graph, source_nodes) if graph.n_nodes else []
    if not sources:
        return _none("rank")
    ranks, _, _ = personalized_pagerank(
        graph, sources, damping=float(damping_factor),
        max_iterations=int(max_iterations))
    return _rows(graph, rank=ranks)


def katz_centrality_get(source, alpha=0.2, epsilon=1e-2, *,
                        cache=GLOBAL_GRAPH_CACHE, pool=GLOBAL_WARM_POOL,
                        device=None) -> dict:
    """``katz_centrality.get``: node, rank (500 iterations at most)."""
    graph = cache.get(source, device=device)
    if graph.n_nodes == 0:
        return _none("rank")

    def compute(x0):
        xs, _, iters = katz_centrality(graph, alpha=float(alpha),
                                       tol=float(epsilon),
                                       max_iterations=500, x0=x0)
        return xs, iters

    xs = _warm(pool, source, graph, "katz",
               ("katz", float(alpha), float(epsilon)), compute)
    return _rows(graph, rank=xs)


def community_detection_get(source, max_iterations=30, weight_property=None,
                            *, cache=GLOBAL_GRAPH_CACHE,
                            pool=GLOBAL_WARM_POOL, device=None) -> dict:
    """``community_detection.get``: node, community_id, the labels
    compacted to 1..k in label order."""
    graph = cache.get(source, weight_property=weight_property, device=device)
    if graph.n_nodes == 0:
        return _none("community_id")

    def compute(labels0):
        return label_propagation(graph, max_iterations=int(max_iterations),
                                 labels0=labels0)

    labels = _warm(pool, source, graph, "labelprop",
                   ("labelprop", int(max_iterations), weight_property),
                   compute)
    uniq = np.unique(labels)
    return _rows(graph, community_id=np.searchsorted(uniq, labels) + 1)


def weakly_connected_components_get(source, *, cache=GLOBAL_GRAPH_CACHE,
                                    pool=GLOBAL_WARM_POOL,
                                    device=None) -> dict:
    """``weakly_connected_components.get`` (``wcc.get``): node,
    component_id."""
    graph = cache.get(source, device=device)
    if graph.n_nodes == 0:
        return _none("component_id")

    def compute(comp0):
        return weakly_connected_components(graph, comp0=comp0)

    comp = _warm(pool, source, graph, "wcc", ("wcc",), compute)
    return _rows(graph, component_id=comp)


def strongly_connected_components_get(source, *, cache=GLOBAL_GRAPH_CACHE,
                                      device=None) -> dict:
    """``strongly_connected_components.get``: node, component_id."""
    graph = cache.get(source, device=device)
    if graph.n_nodes == 0:
        return _none("component_id")
    return _rows(graph, component_id=strongly_connected_components(graph))


def degree_centrality_get(source, type="undirected", *,
                          cache=GLOBAL_GRAPH_CACHE, device=None) -> dict:
    """``degree_centrality.get``: node, degree; ``type`` "in" or "out"
    (any case), anything else the total."""
    graph = cache.get(source, device=device)
    if graph.n_nodes == 0:
        return _none("degree")
    direction = {"in": "in", "out": "out"}.get(str(type).lower(), "total")
    return _rows(graph, degree=degree_centrality(graph, direction))


def hits_get(source, max_iterations=100, tolerance=1e-6, *,
             cache=GLOBAL_GRAPH_CACHE, device=None) -> dict:
    """``hits.get``: node, hub, authority."""
    graph = cache.get(source, device=device)
    if graph.n_nodes == 0:
        return _none("hub", "authority")
    hub, auth, _, _ = hits(graph, max_iterations=int(max_iterations),
                           tol=float(tolerance))
    return _rows(graph, hub=hub, authority=auth)


def betweenness_centrality_get(source, directed=True, normalized=True,
                               samples=0, *, cache=GLOBAL_GRAPH_CACHE,
                               device=None) -> dict:
    """``betweenness_centrality.get``: node, betweenness_centrality;
    exact when ``samples`` is 0, else that many sampled sources."""
    graph = cache.get(source, device=device)
    if graph.n_nodes == 0:
        return _none("betweenness_centrality")
    bc = betweenness_centrality(graph, directed=bool(directed),
                                normalized=bool(normalized),
                                samples=int(samples) or None)
    return _rows(graph, betweenness_centrality=bc)


def bfs_get(source, start, directed=True, *, cache=GLOBAL_GRAPH_CACHE,
            device=None) -> dict:
    """``bfs.get``: node, level, for the vertices reached from the vertex
    with gid ``start``."""
    graph = cache.get(source, device=device)
    sidx = graph.gid_to_idx.get(start) if graph.n_nodes else None
    if sidx is None:
        return _none("level")
    levels, _ = bfs_levels(graph, sidx, directed=bool(directed))
    levels = _host(levels)
    return _rows(graph, levels >= 0, level=levels)


def sssp_get(source, start, weight_property="weight", *,
             cache=GLOBAL_GRAPH_CACHE, device=None) -> dict:
    """``sssp.get``: node, distance, for the vertices reached from the
    vertex with gid ``start`` over the edges' ``weight_property``."""
    graph = cache.get(source, weight_property=weight_property, device=device)
    sidx = graph.gid_to_idx.get(start) if graph.n_nodes else None
    if sidx is None:
        return _none("distance")
    dist, _ = sssp(graph, sidx, weighted=True, directed=True)
    dist = _host(dist)
    return _rows(graph, np.isfinite(dist), distance=dist)


def graph_util_khop(source, sources, hops, directed=False, *,
                    cache=GLOBAL_GRAPH_CACHE, device=None) -> dict:
    """``graph_util.khop``: node, for the vertices within ``hops`` hops
    of the vertices with gids ``sources``."""
    graph = cache.get(source, device=device)
    idxs = _indices(graph, sources) if graph.n_nodes else []
    if not idxs:
        return _none()
    mask = _host(khop_neighborhood(graph, idxs, int(hops),
                                   directed=bool(directed)))
    return _rows(graph, mask)


#: the procedure each function answers
PROCEDURES = {
    "pagerank.get": pagerank_get,
    "pagerank.personalized": pagerank_personalized,
    "katz_centrality.get": katz_centrality_get,
    "community_detection.get": community_detection_get,
    "weakly_connected_components.get": weakly_connected_components_get,
    "strongly_connected_components.get": strongly_connected_components_get,
    "degree_centrality.get": degree_centrality_get,
    "hits.get": hits_get,
    "betweenness_centrality.get": betweenness_centrality_get,
    "bfs.get": bfs_get,
    "sssp.get": sssp_get,
    "graph_util.khop": graph_util_khop,
}
