"""Host results of ``igraphalg.pagerank`` and
``igraphalg.shortest_path_length``, from a storage snapshot.

Port of the compute half of those two procedures of
memgraph_tpu/procedures/igraph_module.py: PageRank (ops/pagerank.py) on
the snapshot, or, with ``directed=False``, on the snapshot's edges taken
both ways (``from_coo`` with its node gids); and single-source shortest
paths (ops/traversal.sssp), over the edges' ``weights`` property when it
is given, else in hops.  Vertices are named by gid; one outside the
snapshot raises ``ProcedureError`` with the reference's message.
"""

from __future__ import annotations

import math

import numpy as np

from ..ops.csr import GLOBAL_GRAPH_CACHE, from_coo
from ..ops.pagerank import pagerank
from ..ops.traversal import sssp
from . import ProcedureError


def _dense_index(graph, gid) -> int:
    idx = graph.gid_to_idx.get(gid) if gid is not None else None
    if idx is None:
        raise ProcedureError("vertex is not part of the current graph")
    return int(idx)


def pagerank_get(source, damping=0.85, weights=None, directed=True,
                 implementation="prpack", *, cache=GLOBAL_GRAPH_CACHE,
                 device=None) -> dict:
    """``igraphalg.pagerank``: node, rank."""
    if implementation not in ("prpack", "arpack"):
        raise ProcedureError(
            'Implementation argument value can be "prpack" or "arpack"')
    graph = cache.get(source, weight_property=weights, device=device)
    gids = np.asarray(graph.node_gids, dtype=np.int64)
    if graph.n_nodes == 0:
        return {"node_gids": gids, "rank": np.zeros(0, np.float32)}
    if not directed:
        # each edge walks both ways
        src, dst, w = graph.host_edges()
        graph = from_coo(np.concatenate([src, dst]),
                         np.concatenate([dst, src]), np.concatenate([w, w]),
                         n_nodes=graph.n_nodes,
                         node_gids=graph.node_gids).to_device(graph.device)
    ranks, _, _ = pagerank(graph, damping=float(damping))
    return {"node_gids": gids, "rank": ranks.cpu().numpy()}


def shortest_path_length(source, source_node, target, weights=None,
                         directed=True, *, cache=GLOBAL_GRAPH_CACHE,
                         device=None) -> dict:
    """``igraphalg.shortest_path_length``: length from the vertex with gid
    ``source_node`` to the one with gid ``target`` (inf when it is not
    reached); one record."""
    graph = cache.get(source, weight_property=weights, device=device)
    src = _dense_index(graph, source_node)
    dst = _dense_index(graph, target)
    dist, _ = sssp(graph, src, weighted=weights is not None,
                   directed=bool(directed))
    length = float(dist[dst])
    return {"length": np.asarray(
        [length if math.isfinite(length) else math.inf])}
