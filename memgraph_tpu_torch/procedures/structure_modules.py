"""Host results of the Louvain and node-similarity procedures, from a
storage snapshot.

Port of the compute half of memgraph_tpu/procedures/structure_modules.py
(``community_detection.louvain``, ``node_similarity.jaccard``,
``.overlap``, ``.cosine`` and ``.pairwise``).  ``louvain`` runs the
host Louvain (ops/louvain.py) on the snapshot's edges; its records are
``node_gids``, ``community_id`` (the community + 1) and ``modularity``
(the partition's, on every record).  The all-pairs procedures take the dense path
(ops/similarity.py) and refuse a graph of more than ``DENSE_LIMIT``
nodes as the reference does; their records are the pairs i < j with a
positive similarity, row by row.  ``pairwise`` takes gid pairs (a pair
that is not two gids of the snapshot is skipped).  Records are host
numpy columns: ``node1_gids``, ``node2_gids``, ``similarity``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.csr import GLOBAL_GRAPH_CACHE
from ..ops.louvain import louvain
from ..ops.similarity import (DENSE_LIMIT, pairwise_similarity,
                              similarity_matrix)
from . import ProcedureError


def _records(graph, i, j, sim) -> dict:
    gids = np.asarray(graph.node_gids, dtype=np.int64)
    return {"node1_gids": gids[np.asarray(i, dtype=np.int64)],
            "node2_gids": gids[np.asarray(j, dtype=np.int64)],
            "similarity": np.asarray(sim, dtype=np.float64)}


def community_detection_louvain(source, weight_property=None, *,
                                cache=GLOBAL_GRAPH_CACHE,
                                device=None) -> dict:
    """``community_detection.louvain``: node, community_id (from 1),
    modularity."""
    graph = cache.get(source, weight_property=weight_property, device=device)
    gids = np.asarray(graph.node_gids, dtype=np.int64)
    if graph.n_nodes == 0:
        return {"node_gids": gids, "community_id": np.zeros(0, np.int64),
                "modularity": np.zeros(0)}
    comm, modularity = louvain(graph)
    return {"node_gids": gids, "community_id": comm + 1,
            "modularity": np.full(graph.n_nodes, modularity)}


def node_similarity_all(source, mode, *, cache=GLOBAL_GRAPH_CACHE,
                        device=None) -> dict:
    """``node_similarity.<mode>`` (jaccard, overlap, cosine): node1,
    node2, similarity over all pairs."""
    graph = cache.get(source, device=device)
    n = graph.n_nodes
    if n == 0:
        return _records(graph, [], [], [])
    if n > DENSE_LIMIT:
        raise ProcedureError(
            f"all-pairs similarity supports up to {DENSE_LIMIT} nodes; "
            f"use node_similarity.pairwise for larger graphs")
    sim = similarity_matrix(graph, mode)
    i, j = torch.nonzero(torch.triu(sim, diagonal=1) > 0, as_tuple=True)
    return _records(graph, i.cpu().numpy(), j.cpu().numpy(),
                    sim[i, j].cpu().numpy())


def node_similarity_pairwise(source, pairs, mode="jaccard", *,
                             cache=GLOBAL_GRAPH_CACHE, device=None) -> dict:
    """``node_similarity.pairwise``: node1, node2, similarity of each
    pair of gids (host set operations)."""
    graph = cache.get(source, device=device)
    index_pairs = []
    for pair in pairs:
        if not isinstance(pair, (list, tuple)) or len(pair) != 2:
            continue
        ia, ib = (graph.gid_to_idx.get(g) if g is not None else None
                  for g in pair)
        if ia is not None and ib is not None:
            index_pairs.append((ia, ib))
    out = pairwise_similarity(graph, index_pairs, str(mode))
    return _records(graph, [p[0] for p in out], [p[1] for p in out],
                    [p[2] for p in out])

