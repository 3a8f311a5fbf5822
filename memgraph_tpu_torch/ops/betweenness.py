"""Betweenness centrality: batched Brandes on the device, in PyTorch.

Port of memgraph_tpu/ops/betweenness.py (unweighted Brandes, as the
reference module).  Sources run in chunks of B as the lanes of one
level-synchronous loop over (n_pad, B) state, each level a run sum of the
deterministic segment kernel (ops/segment_cuda.py ``csr_spmm_sum``):

  forward   sigma_new = Σ_{u→v} x[u] over the CSC runs of the deduplicated
            pairs, x = where(dist == level, sigma, 0): the path counts of
            the next level (exact while they stay under 2^24)
  backward  delta[u] = sigma[u] · Σ_{u→v} y[v] over the CSR runs, kept
            where dist[u] == level, y = where(dist == level + 1,
            (1 + delta) / max(sigma, 1), 0): the reference's per-edge
            sigma[u] / sigma[v] · (1 + delta[v]) with sigma[u] factored
            out, so no (B, E) temporary is built (the rounding differs
            from the reference's)

The host reads whether a level discovered anything once a forward level,
as the reference's ``while_loop`` condition does; the backward loop walks
the levels found.  The deduplicated pairs, the sampling, the chunk size
and the order in which the chunks' sums add up are the reference's; the
pairs and their runs are built on the device, once a call.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import segment_cuda as SC
from .csr import DeviceGraph
from .pagerank import graph_device, on_device

INF = 3.0e38


def _brandes_forward(A, sources, n_pad: int, max_levels: int):
    """The forward sweep of one chunk, a source a lane: (dist, sigma, the
    levels walked), (n_pad, B) float32 hop counts (``INF`` unreached) and
    shortest-path counts.  The host reads once a level whether it
    discovered a node."""
    dev = sources.device
    B = sources.numel()
    lanes = torch.arange(B, device=dev)
    dist = torch.full((n_pad, B), INF, dtype=torch.float32, device=dev)
    sigma = torch.zeros((n_pad, B), dtype=torch.float32, device=dev)
    dist[sources, lanes] = 0.0
    sigma[sources, lanes] = 1.0
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    level, progressed = 0, True
    while progressed and level < max_levels:
        x = torch.where(dist == level, sigma, zero)
        sig_new = SC.csr_spmm_sum(x, A["csc_ptr"], A["csc_src"], mul="first",
                                  longest=A["csc_longest"])
        newly = (dist >= INF / 2) & (sig_new > 0)
        dist = torch.where(newly, torch.full_like(dist, level + 1.0), dist)
        sigma = torch.where(newly, sig_new, sigma)
        progressed = bool(newly.any())
        level += 1
    return dist, sigma, level


def _brandes_chunk(A, sources, weights, n_pad: int, max_levels: int):
    """The weighted sum over the chunk's sources of their dependency
    scores, (n_pad,); ``weights`` (B,) are 0 for the padding lanes.
    Returns (scores, levels walked)."""
    dist, sigma, level = _brandes_forward(A, sources, n_pad, max_levels)
    zero = torch.zeros((), dtype=torch.float32, device=sources.device)
    one = torch.ones((), dtype=torch.float32, device=sources.device)
    delta = torch.zeros_like(sigma)
    for lv in range(level - 1, -1, -1):
        y = torch.where(dist == lv + 1,
                        (1.0 + delta) / torch.maximum(sigma, one), zero)
        add = sigma * SC.csr_spmm_sum(y, A["csr_ptr"], A["csr_dst"],
                                      mul="first", longest=A["csr_longest"])
        delta = torch.where(dist == lv, add, delta)
    # sources accumulate no dependency for their own BFS
    delta[sources, torch.arange(sources.numel(), device=sources.device)] = 0.0
    return (delta * weights).sum(dim=1), level


def _runs(keys, n_pad: int):
    """(n_pad + 1,) int32 offsets of sorted keys, and the longest run."""
    counts = torch.bincount(keys, minlength=n_pad)
    ptr = torch.zeros(n_pad + 1, dtype=torch.int32, device=keys.device)
    ptr[1:] = torch.cumsum(counts, 0)
    return ptr, int(counts.max()) if counts.numel() else 0


def pair_runs(graph: DeviceGraph, directed: bool, device) -> tuple:
    """(A, n_pad): the deduplicated pairs' runs on ``device``, CSR (out of
    each node, (src, dst) order) for the backward sums and CSC (into each,
    (dst, src) order) for the forward ones, with their longest runs;
    built once a call, on the device."""
    g = on_device(graph, device)
    src, dst = _dedup_pairs(g.src_idx[:g.n_edges].long(),
                            g.col_idx[:g.n_edges].long(), g.n_nodes,
                            directed)
    csr_ptr, csr_longest = _runs(src, g.n_pad)
    csc_ptr, csc_longest = _runs(dst, g.n_pad)
    by_dst = torch.sort(dst, stable=True).indices
    return {"csc_ptr": csc_ptr, "csc_src": src[by_dst].to(torch.int32),
            "csc_longest": csc_longest, "csr_ptr": csr_ptr,
            "csr_dst": dst.to(torch.int32), "csr_longest": csr_longest,
            "n_pairs": src.numel()}, g.n_pad


def autotune_chunk(n_edges: int, n_pad: int,
                   budget_bytes: int | None = None) -> int:
    """The source-chunk size B from a device-memory budget: the
    reference's rule, unchanged (~2 (B, E) f32 temporaries and 3 (B,
    n_pad) f32 carries a source row, under a budget of 4 GiB or
    MEMGRAPH_TPU_BC_MEM_BUDGET_MB), since the chunking fixes the order in
    which the chunks' sums add up."""
    if budget_bytes is None:
        budget_bytes = int(os.environ.get(
            "MEMGRAPH_TPU_BC_MEM_BUDGET_MB", 4096)) << 20
    per_row = 2 * n_edges * 4 + 3 * n_pad * 4
    return int(max(1, min(64, budget_bytes // max(per_row, 1))))


def n_levels_bound(n: int) -> int:
    """BFS level cap: the diameter cannot exceed n - 1; bounded."""
    return max(2, min(n, 10_000))


def _dedup_pairs(src, dst, n: int, directed: bool):
    """(src, dst) of the simple graph the paths count on, in (src, dst)
    order: self-loops dropped, parallel edges once; undirected pairs
    canonicalized to (min, max), then mirrored (each direction once).
    The reference's host-side ``np.unique`` of the pairs, as one int64
    key a pair on the edges' device."""
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if not directed:
        src, dst = torch.minimum(src, dst), torch.maximum(src, dst)
    key = torch.unique(src * n + dst)
    if not directed:
        key = torch.sort(torch.cat([key, (key % n) * n + key // n])).values
    return key // n, key % n


def betweenness_centrality(graph: DeviceGraph, directed: bool = True,
                           normalized: bool = True, samples=None,
                           chunk=None, seed: int = 0,
                           max_levels: int | None = None, device=None,
                           stats: dict | None = None):
    """Betweenness scores (n_nodes,) as a float32 tensor on the device.
    ``samples=None`` → exact (every source); an int → the sampled
    approximation (``np.random.default_rng(seed).choice`` of the
    sources) scaled by n / samples.  ``chunk=None`` → ``autotune_chunk``;
    the last chunk pads with zero-weighted repeats of its first source.
    ``device``: explicit, else the graph's, else the card.  ``stats``
    (port only), when given, is filled with the ``chunk`` size and the
    ``levels`` each chunk walked."""
    dev = graph_device(graph, device)
    n = graph.n_nodes
    walked_levels = []
    if stats is not None:
        stats.update(chunk=chunk, levels=walked_levels)
    if n == 0:
        return torch.zeros(0, dtype=torch.float32, device=dev)
    A, n_pad = pair_runs(graph, directed, dev)
    if samples is None or samples >= n:
        sources = np.arange(n, dtype=np.int32)
        scale = 1.0
    else:
        rng = np.random.default_rng(seed)
        sources = rng.choice(n, size=int(samples),
                             replace=False).astype(np.int32)
        scale = n / float(len(sources))
    if chunk is None:
        chunk = autotune_chunk(A["n_pairs"], graph.n_pad)
    if stats is not None:
        stats["chunk"] = chunk
    levels = max_levels if max_levels is not None else n_levels_bound(n)
    bc = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    for i in range(0, len(sources), chunk):
        part = sources[i:i + chunk]
        pad = chunk - len(part)
        padded = (np.concatenate([part, np.full(pad, part[0], np.int32)])
                  if pad else part)
        w = np.concatenate([np.ones(len(part), np.float32),
                            np.zeros(pad, np.float32)])
        got, walked = _brandes_chunk(
            A, torch.from_numpy(padded.astype(np.int64)).to(dev),
            torch.from_numpy(w).to(dev), n_pad, levels)
        walked_levels.append(walked)
        bc = bc + got
    bc = bc[:n] * scale
    if not directed:
        bc = bc / 2.0
    if normalized and n > 2:
        denom = (n - 1) * (n - 2)
        if not directed:
            denom /= 2.0
        bc = bc / denom
    return bc
