"""Host results of ``graphrag.retrieve``, from an index and a graph
snapshot.

Port of the in-process leg of memgraph_tpu/procedures/graphrag.py's
``graphrag.retrieve``: the ``k_seeds`` rows of the embedding index
(procedures/vector_search.py) nearest the query are the seeds; the
vertices within ``hops`` undirected hops of them
(ops/traversal.khop_neighborhood) keep their personalized PageRank
restarted on the seeds (100 iterations at most); the ``limit`` best of
those with a positive score are the records, each with its seed
similarity (0.0 for a vertex that is not a seed).

With ``kernel=`` (or ``MEMGRAPH_TPU_ANALYTICS_KERNEL_SERVER``) naming a
daemon, the expansion and the rerank are the reference's one coalesced
round trip instead: the records are the reply's ``topk_val`` /
``topk_idx`` (the PPR's top ``limit``, with no k-hop mask, as the
reference's routed leg gives them); a failure of the plane falls back to
the in-process leg, loudly (procedures/graph_algorithms.py
``_kernel_server_ppr``).

Left out: ``graphrag.context`` and ``graphrag.schema``, which format
storage labels and properties for a prompt and compute nothing (they
stay with the Cypher layer).
"""

from __future__ import annotations

import numpy as np

from ..ops.csr import GLOBAL_GRAPH_CACHE
from ..ops.pagerank import personalized_pagerank
from ..ops.traversal import khop_neighborhood
from .graph_algorithms import _kernel_server_ppr
from .vector_search import (GLOBAL_INDEX_CACHE, _none, _query,
                            _search_entry, served_topk)


def retrieve(source, property, query_vector, k_seeds, hops=2, limit=10,
             damping=0.85, metric="cosine", *, cache=GLOBAL_GRAPH_CACHE,
             index_cache=GLOBAL_INDEX_CACHE, device=None,
             kernel=None) -> dict:
    """``graphrag.retrieve``: node, score, seed_similarity."""
    fields = ("score", "seed_similarity")
    entry = index_cache.get(source, str(property), device)
    if entry.matrix is None:
        return _none(*fields)
    graph = cache.get(source, device=device)
    if graph.n_nodes == 0:
        return _none(*fields)
    sims, idx = _search_entry(entry, _query(entry, query_vector),
                              int(k_seeds), str(metric))
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
        return {"node_gids": np.asarray(graph.node_gids,
                                        dtype=np.int64)[order],
                "score": scores,
                "seed_similarity": np.asarray([seed_sim.get(int(i), 0.0)
                                               for i in order])}
    mask = khop_neighborhood(graph, seeds, int(hops),
                             directed=False).cpu().numpy()
    ranks, _, _ = personalized_pagerank(graph, seeds, damping=float(damping),
                                        max_iterations=100)
    scores = np.where(mask, ranks.cpu().numpy(), 0.0)
    order = np.argsort(-scores)[:int(limit)]
    order = order[scores[order] > 0]
    return {"node_gids": np.asarray(graph.node_gids, dtype=np.int64)[order],
            "score": scores[order],
            "seed_similarity": np.asarray([seed_sim.get(int(i), 0.0)
                                           for i in order])}
