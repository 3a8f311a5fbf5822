"""Edge deltas between snapshots and the warm pool of commit-then-CALL.

Port of the in-process half of memgraph_tpu/ops/delta.py:

  * :class:`EdgeDelta`: one commit range's edge changes as added and
    removed COO blocks over dense node indices (a weight update is a
    remove and an add of the same pair), with ``adds_only`` (the
    monotone gate of WCC and label propagation), ``doubled``,
    ``wsum_adjust``, ``touched_nodes`` and the array form.
  * The edge diffs (numpy on host COO arrays, ``DeviceGraph.host_coo``'s
    layout): ``incident_edges``, ``multiset_edge_diff``,
    ``diff_incident``, ``diff_changed_coo``.
  * ``splice_coo`` and ``refresh_device_graph``: a snapshot of the same
    node set from the previous one and a delta, through ``from_coo``.
  * The warm-start contract (``WARM_START_POLICY``,
    ``warm_start_decision``): PageRank, PPR and katz are contractions
    with one fixpoint, so any previous solution seeds them; WCC's min
    labels and label propagation's election are seeded only when every
    delta since the seed's solution added edges and removed none, else
    the call starts cold, and says so in a warning.
  * :class:`LocalWarmPool` (``GLOBAL_WARM_POOL``): per storage (weakly),
    the previous solution of each algorithm and the COO snapshot it was
    computed on.  A repeated CALL on an unchanged graph returns the
    stored bytes; a CALL after a commit seeds its fixpoint from them
    under the contract.  It reads a source (ops/csr.py): ``storage``,
    ``version`` and ``changes_between``.  The reference's metrics
    (``delta.warm_start_total``, ``delta.cold_start_total``, the
    ``delta.warm_start_iterations`` histogram) are the pool's two
    ``counters`` here, and each stored solution keeps the iterations
    that computed it (``solution(...).iters``).

The kernel server's parts of the reference module (``compile_edge_delta``
and ``incident_from_storage``, ``apply_edge_delta`` over a sharded CSR,
``ResidentGraph`` / ``ResidentRegistry``) are not ported.
"""

from __future__ import annotations

import logging
import threading
import weakref
from dataclasses import dataclass

import numpy as np

from .csr import ChangeLogUnknowable, DeviceGraph, from_coo

log = logging.getLogger(__name__)

#: per-algorithm warm-start contracts:
#:   "always"     a contraction with one fixpoint: any seed converges to
#:                the same answer at the same tol
#:   "adds_only"  a monotone iteration: warm only when every delta since
#:                the seed's solution added edges and removed none
WARM_START_POLICY = {
    "pagerank": "always",
    "ppr": "always",
    "katz": "always",
    "wcc": "adds_only",
    "labelprop": "adds_only",
}


@dataclass(frozen=True)
class EdgeDelta:
    """Added and removed edge COO blocks over dense node indices; the
    node set is the same across the range it covers."""

    base_version: int
    version: int
    add_src: np.ndarray        # (a,) int64 dense indices
    add_dst: np.ndarray
    add_w: np.ndarray          # (a,) float32
    rem_src: np.ndarray        # (r,) int64 dense indices
    rem_dst: np.ndarray
    rem_w: np.ndarray          # (r,) float32

    @property
    def n_delta(self) -> int:
        return len(self.add_src) + len(self.rem_src)

    @property
    def adds_only(self) -> bool:
        """True when no edge was removed: the warm-start precondition of
        WCC and label propagation."""
        return len(self.rem_src) == 0

    def doubled(self) -> "EdgeDelta":
        """Both edge directions (the undirected view)."""
        return EdgeDelta(
            base_version=self.base_version, version=self.version,
            add_src=np.concatenate([self.add_src, self.add_dst]),
            add_dst=np.concatenate([self.add_dst, self.add_src]),
            add_w=np.concatenate([self.add_w, self.add_w]),
            rem_src=np.concatenate([self.rem_src, self.rem_dst]),
            rem_dst=np.concatenate([self.rem_dst, self.rem_src]),
            rem_w=np.concatenate([self.rem_w, self.rem_w]))

    def wsum_adjust(self, n_nodes: int) -> np.ndarray:
        """The change of each node's out-weight sum (float64)."""
        adj = np.zeros(n_nodes, dtype=np.float64)
        if len(self.add_src):
            np.add.at(adj, self.add_src, self.add_w.astype(np.float64))
        if len(self.rem_src):
            np.subtract.at(adj, self.rem_src,
                           self.rem_w.astype(np.float64))
        return adj

    def touched_nodes(self) -> np.ndarray:
        """The sorted dense indices incident to the delta."""
        return np.unique(np.concatenate([
            self.add_src, self.add_dst, self.rem_src, self.rem_dst]))

    def to_arrays(self) -> dict:
        return {"delta_add_src": self.add_src.astype(np.int64),
                "delta_add_dst": self.add_dst.astype(np.int64),
                "delta_add_w": self.add_w.astype(np.float32),
                "delta_rem_src": self.rem_src.astype(np.int64),
                "delta_rem_dst": self.rem_dst.astype(np.int64),
                "delta_rem_w": self.rem_w.astype(np.float32)}

    @classmethod
    def from_arrays(cls, base_version: int, version: int,
                    arrays: dict) -> "EdgeDelta | None":
        need = ("delta_add_src", "delta_add_dst", "delta_add_w",
                "delta_rem_src", "delta_rem_dst", "delta_rem_w")
        if any(k not in arrays for k in need):
            return None
        return cls(
            base_version=int(base_version), version=int(version),
            add_src=np.asarray(arrays["delta_add_src"], dtype=np.int64),
            add_dst=np.asarray(arrays["delta_add_dst"], dtype=np.int64),
            add_w=np.asarray(arrays["delta_add_w"], dtype=np.float32),
            rem_src=np.asarray(arrays["delta_rem_src"], dtype=np.int64),
            rem_dst=np.asarray(arrays["delta_rem_dst"], dtype=np.int64),
            rem_w=np.asarray(arrays["delta_rem_w"], dtype=np.float32))


def empty_delta(base_version: int, version: int) -> EdgeDelta:
    z = np.zeros(0, dtype=np.int64)
    zf = np.zeros(0, dtype=np.float32)
    return EdgeDelta(base_version, version, z, z, zf, z.copy(), z.copy(),
                     zf.copy())


# --- edge diffs --------------------------------------------------------------


def incident_edges(src, dst, w, bitmap: np.ndarray):
    """The edges with an endpoint in ``bitmap`` (a dense bool mask), in
    order, as (int64, int64, float32) arrays."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    sel = bitmap[src] | bitmap[dst]
    return (src[sel].astype(np.int64), dst[sel].astype(np.int64),
            np.asarray(w, dtype=np.float32)[sel])


def multiset_edge_diff(old_edges, new_edges):
    """((add_src, add_dst, add_w), (rem_src, rem_dst, rem_w)): the
    multiset difference of two (src, dst, w) edge lists, weights compared
    bit for bit.  One lexsort and a run-length count of each edge."""
    o_s, o_d, o_w = (np.asarray(a) for a in old_edges)
    n_s, n_d, n_w = (np.asarray(a) for a in new_edges)
    if len(o_s) + len(n_s) == 0:
        z = np.zeros(0, dtype=np.int64)
        zf = np.zeros(0, dtype=np.float32)
        return (z, z.copy(), zf), (z.copy(), z.copy(), zf.copy())
    src = np.concatenate([n_s.astype(np.int64), o_s.astype(np.int64)])
    dst = np.concatenate([n_d.astype(np.int64), o_d.astype(np.int64)])
    wb = np.concatenate([n_w.astype(np.float32),
                         o_w.astype(np.float32)]).view(np.int32) \
        .astype(np.int64)
    sign = np.concatenate([np.ones(len(n_s), dtype=np.int64),
                           -np.ones(len(o_s), dtype=np.int64)])
    order = np.lexsort((wb, dst, src))
    s2, d2, w2, sg = src[order], dst[order], wb[order], sign[order]
    boundary = (s2[1:] != s2[:-1]) | (d2[1:] != d2[:-1]) \
        | (w2[1:] != w2[:-1])
    starts = np.concatenate([[0], np.nonzero(boundary)[0] + 1])
    net = np.add.reduceat(sg, starts)
    add_rep = np.repeat(starts, np.maximum(net, 0))
    rem_rep = np.repeat(starts, np.maximum(-net, 0))

    def w_back(col):
        return col.astype(np.int32).view(np.float32)

    added = (s2[add_rep], d2[add_rep], w_back(w2[add_rep]))
    removed = (s2[rem_rep], d2[rem_rep], w_back(w2[rem_rep]))
    return added, removed


def diff_incident(prev_coo, changed_idx, inc_src, inc_dst, inc_w,
                  n_nodes: int, base_version: int,
                  version: int) -> EdgeDelta:
    """The EdgeDelta from the current edges incident to the changed
    vertices (``inc_*``; weights 1.0 when ``inc_w`` is None) against
    those of the previous COO.  Edges between unchanged vertices are the
    same by the change log's contract and are not compared."""
    bitmap = np.zeros(n_nodes, dtype=bool)
    ci = np.asarray(changed_idx, dtype=np.int64)
    if len(ci):
        bitmap[ci] = True
    old_inc = incident_edges(*prev_coo, bitmap)
    inc_src = np.asarray(inc_src, dtype=np.int64)
    inc_dst = np.asarray(inc_dst, dtype=np.int64)
    inc_w = (np.ones(len(inc_src), dtype=np.float32) if inc_w is None
             else np.asarray(inc_w, dtype=np.float32))
    (a_s, a_d, a_w), (r_s, r_d, r_w) = multiset_edge_diff(
        old_inc, (inc_src, inc_dst, inc_w))
    return EdgeDelta(base_version, version, a_s, a_d, a_w, r_s, r_d, r_w)


def diff_changed_coo(prev_coo, cur_coo, changed_idx, n_nodes: int,
                     base_version: int, version: int) -> EdgeDelta:
    """The EdgeDelta between two COO snapshots of one node set, over the
    edges incident to ``changed_idx`` (the dense indices the change log
    reported)."""
    bitmap = np.zeros(n_nodes, dtype=bool)
    ci = np.asarray(changed_idx, dtype=np.int64)
    if len(ci):
        bitmap[ci] = True
    cur = incident_edges(*cur_coo, bitmap)
    return diff_incident(prev_coo, changed_idx, cur[0], cur[1], cur[2],
                         n_nodes, base_version, version)


def splice_coo(coo, delta: EdgeDelta, n_nodes: int):
    """(src, dst, w) of a host COO triple with ``delta`` applied: the
    kept edges in order, then the added ones.  Each removal takes the
    first unused edge of its (src, dst, w); None when one has none."""
    src, dst, w = (np.asarray(a) for a in coo)
    w = w.astype(np.float32, copy=False)
    keep = np.ones(len(src), dtype=bool)
    if len(delta.rem_src):
        bitmap = np.zeros(n_nodes, dtype=bool)
        bitmap[delta.rem_src] = True
        bitmap[delta.rem_dst] = True
        cand = np.nonzero(bitmap[src] | bitmap[dst])[0]
        c_key = (src[cand].astype(np.int64) * n_nodes
                 + dst[cand].astype(np.int64))
        c_w = w[cand]
        order = np.argsort(c_key, kind="stable")
        c_key, c_w, cand = c_key[order], c_w[order], cand[order]
        used = np.zeros(len(cand), dtype=bool)
        for s, d, rw in zip(delta.rem_src, delta.rem_dst, delta.rem_w):
            k = int(s) * n_nodes + int(d)
            lo = int(np.searchsorted(c_key, k, side="left"))
            hi = int(np.searchsorted(c_key, k, side="right"))
            hit = -1
            for i in range(lo, hi):
                if not used[i] and c_w[i] == rw:
                    hit = i
                    break
            if hit < 0:
                return None
            used[hit] = True
            keep[cand[hit]] = False
    new_src = np.concatenate([src[keep].astype(np.int64),
                              delta.add_src])
    new_dst = np.concatenate([dst[keep].astype(np.int64),
                              delta.add_dst])
    new_w = np.concatenate([w[keep], delta.add_w])
    return new_src, new_dst, new_w


def refresh_device_graph(prev: DeviceGraph, delta: EdgeDelta, device=None):
    """The snapshot of ``prev``'s node set with ``delta`` spliced into
    its host COO, built by ``from_coo`` and placed on ``device`` (default:
    the card); None when ``prev`` has no host COO or a removal does not
    match."""
    if prev.host_coo is None:
        return None
    coo = splice_coo(prev.host_coo, delta, prev.n_nodes)
    if coo is None:
        return None
    src, dst, w = coo
    g = from_coo(src, dst, w, n_nodes=prev.n_nodes,
                 node_gids=prev.node_gids, pad=True)
    return g.to_device(device)


# --- the warm-start contract -------------------------------------------------


def warm_start_decision(algo: str, monotone_ok: bool):
    """(warm, reason) for seeding ``algo`` from a previous solution whose
    graph moved; ``monotone_ok``: every delta since added edges only,
    and none was unknowable."""
    policy = WARM_START_POLICY.get(algo)
    if policy == "always":
        return True, "contraction"
    if policy == "adds_only":
        if monotone_ok:
            return True, "monotone_adds_only"
        return False, "monotone_unsafe"
    return False, "no_policy"


@dataclass
class _Solution:
    x: np.ndarray
    version: int
    params_key: tuple
    monotone_ok: bool = True
    iters: int | None = None


class LocalWarmPool:
    """Per-storage warm-start state of the in-process procedures: the
    previous solution of each algorithm and the COO snapshot it was
    computed on, so that the next CALL returns it (same graph) or seeds
    its fixpoint from it (a moved graph, under the contract), the
    adds-only gate checked against the real edge diff.

    ``counters``: "warm_start_total" and "cold_start_total" (the loud
    cold starts of the contract).  A stored solution is read-only: a hit
    returns it, and no caller can change what later hits return or what
    later calls are seeded from."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._pool = weakref.WeakKeyDictionary()
        self.counters = {"warm_start_total": 0, "cold_start_total": 0}

    def _monotone_step(self, source, entry, graph: DeviceGraph,
                       version: int) -> bool:
        """Whether the step from the pool's snapshot to ``graph`` at
        ``version`` added edges only (False when the log cannot say)."""
        changed = source.changes_between(entry["version"], version)
        if isinstance(changed, ChangeLogUnknowable) \
                or graph.host_coo is None:
            return False
        changed_idx = [graph.gid_to_idx[g] for g in changed
                       if g in graph.gid_to_idx]
        d = diff_changed_coo(entry["host_coo"], graph.host_coo, changed_idx,
                             graph.n_nodes, entry["version"], version)
        return d.adds_only

    def prepare(self, source, graph: DeviceGraph, version: int, algo: str,
                params_key: tuple):
        """(cached_result, warm_seed), at most one of them not None.

        ``cached_result`` is the stored solution itself when the graph is
        at its version (a repeated CALL returns the same bytes).
        ``warm_seed`` is the (n_nodes,) seed for a graph that moved, under
        the contract; a cold start the contract forces is counted and
        logged here, and drops the stored solution."""
        with self._lock:
            entry = self._pool.get(source.storage)
            if entry is None:
                return None, None
            sol = entry["solutions"].get(algo)
            if sol is None or sol.params_key != tuple(params_key):
                return None, None
            if not np.array_equal(entry["node_gids"], graph.node_gids):
                return None, None      # dense ids moved: no seed
            if version == sol.version:
                return sol.x, None
            monotone_ok = sol.monotone_ok
            if version != entry["version"]:
                monotone_ok = monotone_ok and self._monotone_step(
                    source, entry, graph, version)
            warm, reason = warm_start_decision(algo, monotone_ok)
            if not warm:
                self.counters["cold_start_total"] += 1
                log.warning("delta: COLD start for %s (%s): the previous "
                            "solution cannot seed this fixpoint", algo,
                            reason)
                entry["solutions"].pop(algo, None)
                return None, None
            return None, sol.x

    def store(self, source, graph: DeviceGraph, version: int, algo: str,
              params_key: tuple, x, iters=None) -> None:
        """Keep a read-only copy of ``x``, computed on ``graph`` at
        ``version`` in ``iters`` iterations, as ``algo``'s solution;
        moving the pool's snapshot to this version folds the step's delta
        into every kept solution's adds-only flag."""
        if graph.host_coo is None:
            return
        x = np.array(x)
        x.setflags(write=False)
        with self._lock:
            entry = self._pool.get(source.storage)
            if entry is None or not np.array_equal(entry["node_gids"],
                                                   graph.node_gids):
                entry = {"version": int(version), "host_coo": graph.host_coo,
                         "node_gids": graph.node_gids, "solutions": {}}
            elif entry["version"] != version:
                if not self._monotone_step(source, entry, graph, version):
                    for s in entry["solutions"].values():
                        s.monotone_ok = False
                entry["version"] = int(version)
                entry["host_coo"] = graph.host_coo
            entry["solutions"][algo] = _Solution(
                x=x, version=int(version),
                params_key=tuple(params_key), monotone_ok=True,
                iters=None if iters is None else int(iters))
            self._pool[source.storage] = entry

    def record_warm_start(self, algo: str, iters: int) -> None:
        with self._lock:
            self.counters["warm_start_total"] += 1
        log.debug("delta: warm-started %s converged in %d iterations",
                  algo, iters)

    def solution(self, storage, algo: str):
        """``algo``'s stored solution on ``storage`` (its ``x``,
        ``version`` and ``iters``, the iterations that computed it), or
        None."""
        with self._lock:
            entry = self._pool.get(storage)
            return entry["solutions"].get(algo) if entry else None

    def clear(self) -> None:
        with self._lock:
            self._pool = weakref.WeakKeyDictionary()


GLOBAL_WARM_POOL = LocalWarmPool()
