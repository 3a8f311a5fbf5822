"""Host results of ``kmeans.get_clusters``, from an index snapshot.

Port of the compute half of memgraph_tpu/procedures/utility_modules.py's
``kmeans.get_clusters``: k-means of the live rows of the property's index
snapshot (procedures/vector_search.py), in the index's row order.  The
initial rows are drawn from a ``torch.Generator`` seeded with ``seed``
(ops/knn.py ``kmeans_fit``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.knn import kmeans_fit
from .vector_search import GLOBAL_INDEX_CACHE


def kmeans_get_clusters(source, property, n_clusters, iterations=10, seed=0,
                        *, index_cache=GLOBAL_INDEX_CACHE,
                        device=None) -> dict:
    """``kmeans.get_clusters``: node, cluster_id."""
    none = {"node_gids": np.zeros(0, dtype=np.int64),
            "cluster_id": np.zeros(0, dtype=np.int64)}
    entry = index_cache.get(source, str(property), device)
    if entry.matrix is None:
        return none
    live = [(row, gid) for row, gid in enumerate(entry.row_gids)
            if gid is not None]
    if not live:
        return none
    rows = torch.as_tensor([r for r, _ in live], device=entry.matrix.device)
    matrix = entry.matrix[rows]
    k = max(1, min(int(n_clusters), matrix.shape[0]))
    _, assign = kmeans_fit(matrix, k, int(iterations),
                           torch.Generator().manual_seed(int(seed)))
    return {"node_gids": np.asarray([g for _, g in live], dtype=np.int64),
            "cluster_id": assign.cpu().numpy().astype(np.int64)}

