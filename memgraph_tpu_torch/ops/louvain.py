"""Louvain community detection (modularity maximization), on the host.

Port of memgraph_tpu/ops/louvain.py, community for community: the graph
taken as undirected (each edge in both directions), a local-move phase
with the modularity gain, then the communities aggregated into nodes,
until a level gains less than ``min_gain``.  What decides the answer is
kept as the reference has it: the visiting order
``default_rng(seed).permutation`` (the same seed every level), the strict
``>`` of the best gain (the first community met wins a tie), at most 20
rounds a level, the stable aggregation, and float64 sums in edge order.

The adjacency of a level is built with numpy: each node's neighbours in
the order of their first occurrence in the edge list (the order the
reference's per-node dicts keep, which decides ties), their weights
summed in edge order.  The move loop runs in native/louvain.cpp (the
same double operations in the same order), or in python where no C++
compiler is at hand.  No part of Louvain runs on the card: a parallel
local move would give other communities.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from .native import louvain_move_native


def louvain(graph, max_levels: int = 10, min_gain: float = 1e-7,
            seed: int = 0):
    """(community[:n_nodes] np.int64 compacted to 0..k-1, modularity) of
    a DeviceGraph on any device."""
    n = graph.n_nodes
    if n == 0:
        return np.zeros(0, dtype=np.int64), 0.0
    e_src, e_dst, e_w = graph.host_edges()
    src = np.asarray(e_src).astype(np.int64)
    dst = np.asarray(e_dst).astype(np.int64)
    w = np.asarray(e_w).astype(np.float64)

    # symmetrize
    s = np.concatenate([src, dst])
    d = np.concatenate([dst, src])
    ww = np.concatenate([w, w])

    mapping = np.arange(n, dtype=np.int64)  # node -> final community
    cur_n = n

    for _level in range(max_levels):
        comm, gain = _one_level(cur_n, s, d, ww, min_gain, seed)
        mapping = comm[mapping]
        if gain < min_gain:
            break
        # aggregate: communities become nodes
        uniq, new_ids = np.unique(comm, return_inverse=True)
        mapping = new_ids[mapping]
        s2 = new_ids[s]
        d2 = new_ids[d]
        # merge parallel edges
        keys = s2 * len(uniq) + d2
        order = np.argsort(keys, kind="stable")
        keys_s = keys[order]
        w_s = ww[order]
        boundaries = np.concatenate([[True], keys_s[1:] != keys_s[:-1]])
        group_ids = np.cumsum(boundaries) - 1
        agg_w = np.zeros(group_ids[-1] + 1 if len(group_ids) else 0)
        np.add.at(agg_w, group_ids, w_s)
        first_idx = np.nonzero(boundaries)[0]
        s = keys_s[first_idx] // len(uniq)
        d = keys_s[first_idx] % len(uniq)
        ww = agg_w
        cur_n = len(uniq)
        if cur_n <= 1:
            break

    modularity = _modularity(n, np.concatenate([src, dst]),
                             np.concatenate([dst, src]),
                             np.concatenate([w, w]), mapping)
    # compact ids
    _, compact = np.unique(mapping, return_inverse=True)
    return compact.astype(np.int64), float(modularity)


def _adjacency(n, s, d, w):
    """(indptr, neighbours, summed weights, weighted degree): each node's
    neighbours other than itself in the order of their first occurrence
    among its edges, each pair's weights summed in edge order; the
    degree sums every edge of the node, self loops included."""
    k = np.zeros(n)
    np.add.at(k, s, w)
    off = s != d
    so, do, wo = s[off], d[off], w[off]
    pairs, first, inv = np.unique(so * n + do, return_index=True,
                                  return_inverse=True)
    summed = np.zeros(len(pairs))
    np.add.at(summed, inv.reshape(-1), wo)
    owner = pairs // n
    order = np.lexsort((first, owner))
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(owner, minlength=n), out=indptr[1:])
    return indptr, (pairs % n)[order], summed[order], k


def _move(n, indptr, nbr, nbr_w, k, order, m2, min_gain):
    """The python local-move loop (native/louvain.cpp's plain version):
    (community assignment, total gain)."""
    comm = np.arange(n, dtype=np.int64)
    comm_tot = k.copy()  # total degree per community
    neighbors = [list(zip(nbr[indptr[v]:indptr[v + 1]].tolist(),
                          nbr_w[indptr[v]:indptr[v + 1]].tolist()))
                 for v in range(n)]
    total_gain = 0.0
    improved = True
    rounds = 0
    while improved and rounds < 20:
        improved = False
        rounds += 1
        for v in order:
            cv = comm[v]
            kv = k[v]
            # weights to neighboring communities
            links: dict[int, float] = defaultdict(float)
            for u, wu in neighbors[v]:
                links[comm[u]] += wu
            comm_tot[cv] -= kv
            best_c, best_gain = cv, 0.0
            base = links.get(cv, 0.0) - comm_tot[cv] * kv / m2
            for c, wc in links.items():
                if c == cv:
                    continue
                gain = (wc - comm_tot[c] * kv / m2) - base
                if gain > best_gain:
                    best_gain, best_c = gain, c
            comm[v] = best_c
            comm_tot[best_c] += kv
            if best_c != cv and best_gain > min_gain:
                improved = True
                total_gain += best_gain
    return comm, total_gain


def _one_level(n, s, d, w, min_gain, seed, native: bool = True):
    """Local-move phase; returns (community assignment, total gain)."""
    m2 = w.sum()  # = 2m for the symmetrized graph
    if m2 <= 0:
        return np.arange(n, dtype=np.int64), 0.0
    indptr, nbr, nbr_w, k = _adjacency(n, s, d, w)
    order = np.random.default_rng(seed).permutation(n)
    out = (louvain_move_native(indptr, nbr, nbr_w, k, order, m2, min_gain)
           if native else None)
    if out is None:
        out = _move(n, indptr, nbr, nbr_w, k, order, m2, min_gain)
    return out


def _modularity(n, s, d, w, comm):
    m2 = w.sum()
    if m2 <= 0:
        return 0.0
    internal = w[comm[s] == comm[d]].sum()
    k = np.zeros(n)
    np.add.at(k, s, w)
    comm_deg = defaultdict(float)
    for v in range(n):
        comm_deg[comm[v]] += k[v]
    expected = sum(x * x for x in comm_deg.values()) / (m2 * m2)
    return internal / m2 - expected
