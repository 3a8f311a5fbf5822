"""Node similarity in PyTorch: Jaccard, overlap and cosine of
out-neighborhoods.

Port of memgraph_tpu/ops/similarity.py.  Two regimes:
  - the dense path (n_nodes <= DENSE_LIMIT): the 0/1 out-adjacency as an
    (n, n) matrix, built by a max-scatter of the edges, and the common
    out-neighbor counts as one product A @ Aᵀ.  The reference multiplies
    bfloat16 operands into f32; 0/1 entries are exact in bfloat16 and
    every count (at most n) is exact in f32, so the product of the
    f32 matrix at full f32 precision gives the same counts;
  - the host path: per-pair neighbor-set intersections for given pairs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import exact_f32_matmuls
from .csr import DeviceGraph
from .pagerank import graph_device, on_device

DENSE_LIMIT = 8192


def _adjacency(graph: DeviceGraph):
    """(n, n) f32 0/1 out-adjacency of the true edges: the edge arrays
    clipped into range (the padding edges' sink ids) and masked (a
    padding edge writes 0), max-scattered into zeros."""
    n = graph.n_nodes
    dev = graph.row_ptr.device
    e_mask = (torch.arange(graph.e_pad, device=dev)
              < graph.n_edges).to(torch.float32)
    src = torch.clamp(graph.src_idx.long(), max=n - 1)
    dst = torch.clamp(graph.col_idx.long(), max=n - 1)
    adj = torch.zeros(n * n, dtype=torch.float32, device=dev)
    adj.scatter_reduce_(0, src * n + dst, e_mask, reduce="amax",
                        include_self=True)
    return adj.view(n, n)


def similarity_matrix(graph: DeviceGraph, mode: str = "jaccard",
                      device=None):
    """(n, n) f32 similarity matrix of the out-neighborhoods, on
    ``device`` (explicit, else the graph's, else the card); refused past
    ``DENSE_LIMIT`` nodes.  Any mode but jaccard and overlap is
    cosine."""
    if graph.n_nodes > DENSE_LIMIT:
        raise ValueError(
            f"dense similarity limited to {DENSE_LIMIT} nodes; "
            f"use pairwise_similarity for larger graphs")
    exact_f32_matmuls()
    g = on_device(graph, graph_device(graph, device))
    adj = _adjacency(g)
    common = adj @ adj.T
    deg = torch.sum(adj, dim=1)
    zero = torch.zeros((), device=adj.device)
    if mode == "jaccard":
        union = deg[:, None] + deg[None, :] - common
        return torch.where(union > 0,
                           common / torch.clamp(union, min=1e-9), zero)
    if mode == "overlap":
        m = torch.minimum(deg[:, None], deg[None, :])
        return torch.where(m > 0, common / torch.clamp(m, min=1e-9), zero)
    denom = torch.sqrt(deg[:, None] * deg[None, :])
    return torch.where(denom > 0, common / torch.clamp(denom, min=1e-9),
                       zero)


def pairwise_similarity(graph: DeviceGraph, pairs, mode: str = "jaccard"):
    """[(i, j, score)] for explicit node-index pairs (host set
    operations on the CSR runs); any mode but jaccard and overlap is
    cosine."""
    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else a
    row_ptr = np.asarray(host(graph.row_ptr))
    col = np.asarray(host(graph.col_idx))

    def neigh(v):
        return set(col[row_ptr[v]:row_ptr[v + 1]].tolist())

    out = []
    cache: dict[int, set] = {}
    for (i, j) in pairs:
        si = cache.setdefault(i, neigh(i))
        sj = cache.setdefault(j, neigh(j))
        inter = len(si & sj)
        if mode == "jaccard":
            denom = len(si | sj)
        elif mode == "overlap":
            denom = min(len(si), len(sj))
        else:
            denom = (len(si) * len(sj)) ** 0.5
        out.append((i, j, inter / denom if denom else 0.0))
    return out
