"""Host results of the Leiden and union-find procedures, from a storage
snapshot.

Port of the compute half of memgraph_tpu/procedures/
combinatorial_modules.py's ``leiden_community_detection.get`` (Louvain,
ops/louvain.py, then one constrained local-move sweep on the host that
moves a node only to a neighbouring community of positive gain) and
``union_find.connected`` (WCC on the card, ops/components.py, its labels
by gid kept per storage and reused when ``update`` is False).  Each
function takes a source (ops/csr.py), the procedure's arguments with its
defaults, the snapshot ``cache`` and the ``device``, and returns host
numpy columns.  Vertices are named by gid.
"""

from __future__ import annotations

import collections
import threading
import weakref

import numpy as np

from ..ops.components import weakly_connected_components
from ..ops.csr import GLOBAL_GRAPH_CACHE
from ..ops.louvain import louvain
from . import ProcedureError


def leiden_get(source, weight_property=None, *, cache=GLOBAL_GRAPH_CACHE,
               device=None) -> dict:
    """``leiden_community_detection.get``: node, community_id (the
    refined community, from 0 as the reference numbers it), communities
    (that id as a one-entry list: a (rows, 1) column)."""
    graph = cache.get(source, weight_property=weight_property, device=device)
    gids = np.asarray(graph.node_gids, dtype=np.int64)
    if graph.n_nodes == 0:
        return {"node_gids": gids, "community_id": np.zeros(0, np.int64),
                "communities": np.zeros((0, 1), np.int64)}
    comm, _ = louvain(graph)
    comm = _refine_communities(graph, np.asarray(comm).copy())
    return {"node_gids": gids, "community_id": comm,
            "communities": comm.reshape(-1, 1)}


def _refine_communities(graph, comm):
    """One constrained local-move sweep over the host edges, taken in both
    directions, nodes by decreasing degree."""
    n = graph.n_nodes
    e_src, e_dst, e_w = graph.host_edges()
    e_w = np.asarray(e_w, dtype=np.float64)
    src = np.concatenate([e_src, e_dst])
    dst = np.concatenate([e_dst, e_src])
    w = np.concatenate([e_w, e_w])
    order_idx = np.argsort(src, kind="stable")
    src, dst, w = src[order_idx], dst[order_idx], w[order_idx]
    deg = np.zeros(n)
    np.add.at(deg, src, w)
    two_m = max(deg.sum(), 1e-12)
    comm_deg = np.zeros(comm.max() + 2)
    np.add.at(comm_deg, comm, deg)
    order = np.argsort(-deg[:n])
    starts = np.searchsorted(src, np.arange(n))
    ends = np.searchsorted(src, np.arange(n) + 1)
    for u in order:
        u = int(u)
        links = collections.defaultdict(float)
        for k in range(int(starts[u]), int(ends[u])):
            links[int(comm[dst[k]])] += float(w[k])
        cur = int(comm[u])
        best, best_gain = cur, 0.0
        for c, l_uc in links.items():
            if c == cur:
                continue
            gain = (l_uc - links.get(cur, 0.0)
                    - deg[u] * (comm_deg[c] - comm_deg[cur] + deg[u]) / two_m)
            if gain > best_gain + 1e-12:
                best, best_gain = c, gain
        if best != cur:
            comm_deg[cur] -= deg[u]
            comm_deg[best] += deg[u]
            comm[u] = best
    return comm


#: storage (weakly) -> {gid: WCC label} of the last labelling
_UNION_FIND_LABELS = weakref.WeakKeyDictionary()
_UNION_FIND_LOCK = threading.Lock()


def _wcc_labels(source, update: bool, cache, device) -> dict:
    """gid -> component label of the source's graph: the stored labels
    when ``update`` is False and there are some, else WCC's, stored."""
    with _UNION_FIND_LOCK:
        cached = _UNION_FIND_LABELS.get(source.storage)
    if not update and cached is not None:
        return cached
    graph = cache.get(source, device=device)
    labels = {}
    if graph.n_nodes:
        comp, _ = weakly_connected_components(graph)
        labels = dict(zip(np.asarray(graph.node_gids).tolist(),
                          np.asarray(comp).tolist()))
    with _UNION_FIND_LOCK:
        _UNION_FIND_LABELS[source.storage] = labels
    return labels


def union_find_connected(source, nodes1, nodes2, mode="pairwise",
                         update=True, *, cache=GLOBAL_GRAPH_CACHE,
                         device=None) -> dict:
    """``union_find.connected``: node1, node2, connected, for each pair
    of the gids ``nodes1`` and ``nodes2`` (a gid or a list of them):
    position by position ("pairwise") or every one with every one
    ("cartesian")."""
    labels = _wcc_labels(source, bool(update), cache, device)
    lhs = list(nodes1) if isinstance(nodes1, (list, tuple)) else [nodes1]
    rhs = list(nodes2) if isinstance(nodes2, (list, tuple)) else [nodes2]
    if mode == "pairwise":
        if len(lhs) != len(rhs):
            raise ProcedureError(
                "union_find.connected pairwise mode needs equal-length lists")
        pairs = list(zip(lhs, rhs))
    elif mode == "cartesian":
        pairs = [(a, b) for a in lhs for b in rhs]
    else:
        raise ProcedureError(f"unknown union_find mode {mode!r}")
    connected = [labels.get(a) is not None and labels.get(a) == labels.get(b)
                 for a, b in pairs]
    return {"node1_gids": np.asarray([a for a, _ in pairs], dtype=np.int64),
            "node2_gids": np.asarray([b for _, b in pairs], dtype=np.int64),
            "connected": np.asarray(connected, dtype=bool)}

