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
    ``version`` and ``changes_between``.  Each stored solution keeps the
    iterations that computed it (``solution(...).iters``).

The kernel server's half (server/kernel_server.py):

  * ``incident_from_storage``: the current edges incident to the changed
    vertices, read from a source as ``export_csr_delta`` reads them (the
    payload a client ships instead of the whole edge list), and
    ``compile_edge_delta``: the delta between two snapshots of one node
    set, or the source's ``ChangeLogUnknowable`` (falsy) when its log
    wrapped, or None when the node set moved.
  * :class:`ResidentGraph`: one resident generation of a graph key, its
    host COO spliced O(delta) by ``apply`` (an oversized delta, or deltas
    accumulated past ``DELTA_COMPACT_FRACTION`` of the edges, compact:
    counted, the COO is exact either way), its snapshot rebuilt lazily,
    and the last solution of each algorithm (``note_solution``; a hit on
    an unmoved generation is ``cached_result``, a seed under the contract
    ``warm_x0``).  A lazy snapshot carries the lineage that
    ``GraphCache`` gives (``_delta_ctx = (anchor, changed gids)``, the
    anchor the newest snapshot of the generation with a full MXU plan),
    so PageRank refreshes it through a ``DeltaPlan`` instead of a plan
    build (ops/pagerank.py ``_try_delta_plan``).
  * :class:`ResidentRegistry`: the bounded LRU of generations by key.

The reference's metrics (``delta.applied_total``,
``delta.compacted_total``, ``delta.fallback_rebuild_total``,
``delta.warm_start_total``, ``delta.cold_start_total``, the
``delta.edge_count`` and ``delta.warm_start_iterations`` summaries and
the ``delta.resident_generations`` gauge) count the work of the warm
pool, the resident layer and ``GraphCache`` in
``utils.metrics.global_metrics``, which the server's health reply
ships.

``apply_edge_delta`` splices a delta into a host ``ShardedCSR``
(ops/csr.py), rewriting only the rows it touches.  A resident
generation's partition-centric variants (``ResidentGraph.ensure_sharded``:
the host layout per (by, doubled), planned with ``TIER_ROW_SLACK`` of room
a row, and its placement per mesh) and its streamed paging plans
(``ensure_tier``, ops/tier.py) move by it on every commit: only the
touched rows are rewritten (blocks re-packed), no global sort runs, and
a moved variant is placed again at its next use.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np

from ..observability import stats as mgstats
from ..observability import trace as mgtrace
from ..utils.locks import fork_safe
from ..utils.metrics import global_metrics
from .csr import (ChangeLogUnknowable, DeviceGraph, ShardedCSR, _raw,
                  _weights, from_coo, shard_edges)

log = logging.getLogger(__name__)

#: once the edges applied since the last compaction pass this fraction of
#: the edge count, the next delta compacts the generation
DELTA_COMPACT_FRACTION = 0.25

#: a single delta larger than this fraction of the edges compacts outright
DELTA_MAX_FRACTION = 0.25

#: the room a generation's paging plan keeps in each row for added edges,
#: as a share of its fullest row (ops/tier.py ``plan_tier(slack=)``): the
#: reference plans rows with none, so the first commit that adds to the
#: fullest row overflows it and drops the plan for a cold re-encode.  It
#: costs this share of padding in the wire bytes of a sweep.
TIER_ROW_SLACK = 1 / 64

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


# --- the server's deltas -----------------------------------------------------


def incident_from_storage(source, gid_to_idx, changed_gids,
                          weight_property=None):
    """Dense (src, dst, w) arrays of the current edges incident to the
    changed vertices, read through the source's ``incident`` (ops/csr.py)
    as ``export_csr_delta`` reads them: each changed vertex's out-edges,
    then its in-edges from unchanged vertices (an edge between two changed
    vertices comes once, with its source).  Weights are the property's
    (1.0 without one).  None when the node set moved: a changed vertex is
    gone, outside the view or has no dense index, or an edge reaches a
    vertex without one."""
    changed = list(changed_gids)
    changed_set = set(changed)
    has_w = weight_property is not None
    out_s: list = []
    out_d: list = []
    out_w: list = []
    for gid in changed:
        idx = gid_to_idx.get(gid)
        inc = source.incident(gid, weight_property)
        if idx is None or inc is None:
            return None
        out_far, out_raw, in_far, in_raw = inc
        out_far = np.asarray(out_far, dtype=np.int64).reshape(-1)
        in_far = np.asarray(in_far, dtype=np.int64).reshape(-1)
        di = [gid_to_idx.get(g) for g in out_far.tolist()]
        keep = [g not in changed_set for g in in_far.tolist()]
        si = [gid_to_idx.get(g) for g, k in zip(in_far.tolist(), keep) if k]
        if None in di or None in si:
            return None
        out_s += [idx] * len(di)
        out_d += di
        out_s += si
        out_d += [idx] * len(si)
        if has_w:
            out_w.append(_weights(_raw(out_raw, len(out_far))))
            out_w.append(_weights(_raw(in_raw, len(in_far)))[
                np.asarray(keep, dtype=bool)])
    w = (np.concatenate([np.zeros(0, np.float32), *out_w])
         if has_w else np.ones(len(out_s), dtype=np.float32))
    return (np.asarray(out_s, dtype=np.int64),
            np.asarray(out_d, dtype=np.int64), w.astype(np.float32))


def compile_edge_delta(source, prev_graph: DeviceGraph,
                       cur_graph: DeviceGraph, base_version: int,
                       version: int):
    """The EdgeDelta between two snapshots of a source covering versions
    (base_version, version], from its change log: an empty delta for one
    version; the log's ``ChangeLogUnknowable`` (falsy: the caller
    rebuilds, loudly) when it cannot say what changed; None when a
    snapshot has no host COO or the node set changed (dense ids moved)."""
    if base_version == version:
        return empty_delta(base_version, version)
    changed = source.changes_between(base_version, version)
    if isinstance(changed, ChangeLogUnknowable):
        return changed
    if prev_graph.host_coo is None or cur_graph.host_coo is None:
        return None
    if prev_graph.n_nodes != cur_graph.n_nodes or \
            not np.array_equal(prev_graph.node_gids, cur_graph.node_gids):
        return None
    changed_idx = [cur_graph.gid_to_idx[g] for g in changed
                   if g in cur_graph.gid_to_idx]
    if len(changed_idx) != len(changed):
        return None               # a changed vertex left or joined the view
    return diff_changed_coo(prev_graph.host_coo, cur_graph.host_coo,
                            changed_idx, cur_graph.n_nodes, base_version,
                            version)


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


def record_warm_start(algo: str, iters: int) -> None:
    """Count a warm-started fixpoint (the warm pool's or the resident
    layer's)."""
    global_metrics.increment("delta.warm_start_total")
    global_metrics.observe("delta.warm_start_iterations", float(iters))
    log.debug("delta: warm-started %s converged in %d iterations",
              algo, iters)


def record_cold_start(algo: str, reason: str) -> None:
    """The loud cold start of the contract: a seed the contract refuses
    is counted and logged, never used quietly."""
    global_metrics.increment("delta.cold_start_total")
    log.warning("delta: COLD start for %s (%s): the previous solution "
                "cannot seed this fixpoint", algo, reason)


@dataclass
class _Solution:
    x: np.ndarray
    version: int
    params_key: tuple
    monotone_ok: bool = True
    iters: int | None = None
    err: float | None = None
    max_iterations: int | None = None


class LocalWarmPool:
    """Per-storage warm-start state of the in-process procedures: the
    previous solution of each algorithm and the COO snapshot it was
    computed on, so that the next CALL returns it (same graph) or seeds
    its fixpoint from it (a moved graph, under the contract), the
    adds-only gate checked against the real edge diff (warm and cold
    starts counted by ``record_warm_start`` / ``record_cold_start``).  A
    stored solution is read-only: a hit returns it, and no caller can
    change what later hits return or what later calls are seeded from."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._pool = weakref.WeakKeyDictionary()

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
                record_cold_start(algo, reason)
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


GLOBAL_WARM_POOL = fork_safe(LocalWarmPool())


# --- the host ShardedCSR splice ----------------------------------------------


def _row_real_count(dst_row: np.ndarray, sink: int) -> int:
    """Real edges in a (dst, src)-sorted row (padding entries all carry
    dst == sink and sort to the tail)."""
    return int(np.searchsorted(dst_row, sink, side="left"))


def _match_removals(row_src, row_dst, row_w, rem_src, rem_dst, rem_w,
                    n_pad2: int):
    """Row positions matching each removal triple, or None if any removal
    has no match (an inconsistent delta: the caller rebuilds).  The row
    is (dst, src)-sorted, so each (dst, src) run is a binary search; the
    weight is matched by a scan of the (tiny) run."""
    key_row = row_dst.astype(np.int64) * n_pad2 + row_src
    out = []
    used: set = set()
    for s, d, w in zip(rem_src, rem_dst, rem_w):
        k = int(d) * n_pad2 + int(s)
        lo = int(np.searchsorted(key_row, k, side="left"))
        hi = int(np.searchsorted(key_row, k, side="right"))
        hit = next((i for i in range(lo, hi)
                    if i not in used and row_w[i] == w), -1)
        if hit < 0:
            return None
        used.add(hit)
        out.append(hit)
    return out


def apply_edge_delta(scsr: ShardedCSR, delta: EdgeDelta):
    """Splice an EdgeDelta into a host ShardedCSR.

    O(delta) index work plus an O(row) merge for the rows the delta
    touches; every other row (its arrays and block_ptr) is kept as it
    is, and the full build's global sort never runs.  Returns the new
    ShardedCSR (``scsr`` itself for an empty delta), or None when the
    splice cannot keep the layout (a row overflows its ``per`` capacity,
    a removal matches no edge, an endpoint lies outside the layout): the
    caller rebuilds."""
    if not isinstance(scsr.src, np.ndarray):
        raise ValueError("apply_edge_delta needs the HOST-side layout")
    if delta.n_delta == 0:
        return scsr
    block, n_shards, per = scsr.block, scsr.n_shards, scsr.per
    sink = scsr.n_nodes
    by_src = scsr.by == "src"
    add_owner = (delta.add_src if by_src else delta.add_dst) // block
    rem_owner = (delta.rem_src if by_src else delta.rem_dst) // block
    affected = np.union1d(np.unique(add_owner), np.unique(rem_owner))
    if len(affected) and (affected.min() < 0
                          or affected.max() >= n_shards):
        return None

    src_b = scsr.src.copy()
    dst_b = scsr.dst.copy()
    w_b = scsr.weights.copy()
    block_ptr = scsr.block_ptr.copy()
    shard_bounds = np.arange(n_shards + 1, dtype=np.int64) * block

    for p in affected:
        p = int(p)
        rc = _row_real_count(dst_b[p], sink)
        r_sel = rem_owner == p
        a_sel = add_owner == p
        row_s, row_d, row_w = src_b[p, :rc], dst_b[p, :rc], w_b[p, :rc]
        keep = np.ones(rc, dtype=bool)
        if r_sel.any():
            hits = _match_removals(
                row_s, row_d, row_w, delta.rem_src[r_sel],
                delta.rem_dst[r_sel], delta.rem_w[r_sel], scsr.n_pad2)
            if hits is None:
                return None
            keep[hits] = False
        a_s = delta.add_src[a_sel]
        a_d = delta.add_dst[a_sel]
        a_w = delta.add_w[a_sel]
        new_rc = int(keep.sum()) + len(a_s)
        if new_rc > per:
            return None           # capacity overflow: compaction
        k_s, k_d, k_w = row_s[keep], row_d[keep], row_w[keep]
        if len(a_s):
            order = np.lexsort((a_s, a_d))
            a_s, a_d, a_w = a_s[order], a_d[order], a_w[order]
            # merge-insert into the (dst, src)-sorted survivors
            kept_key = k_d.astype(np.int64) * scsr.n_pad2 + k_s
            add_key = a_d.astype(np.int64) * scsr.n_pad2 + a_s
            pos = np.searchsorted(kept_key, add_key, side="left")
            k_s = np.insert(k_s, pos, a_s.astype(np.int32))
            k_d = np.insert(k_d, pos, a_d.astype(np.int32))
            k_w = np.insert(k_w, pos, a_w)
        src_b[p, :new_rc] = k_s
        dst_b[p, :new_rc] = k_d
        w_b[p, :new_rc] = k_w
        src_b[p, new_rc:] = np.int32(p * block)   # padding convention
        dst_b[p, new_rc:] = np.int32(sink)
        w_b[p, new_rc:] = 0.0
        block_ptr[p] = np.searchsorted(dst_b[p], shard_bounds)

    n_edges = scsr.n_edges + len(delta.add_src) - len(delta.rem_src)
    return ShardedCSR(src=src_b, dst=dst_b, weights=w_b,
                      block_ptr=block_ptr, n_nodes=scsr.n_nodes,
                      n_edges=n_edges, n_shards=n_shards, block=block,
                      n_pad2=scsr.n_pad2, per=per, by=scsr.by)


# --- resident generations (the kernel server's) ------------------------------


class ResidentGraph:
    """One resident generation of a graph key.

    Owned by one dispatcher at a time (the kernel server's dispatch
    lock): no locking of its own.  The canonical state is the host COO,
    spliced O(delta) per commit; the snapshot (a DeviceGraph on the
    device the first snapshot was placed on) is rebuilt from it on its
    first read after a delta, carrying ``_delta_ctx = (anchor, changed
    gids since the anchor)``: the anchor is the newest snapshot of this
    generation whose MXU plan was a full build (``_mxu_base_self``), so
    PageRank derives the new snapshot's plan from it by a ``DeltaPlan``
    while the change is small, and builds a full plan (the next anchor)
    past ``ops.pagerank.DELTA_RECOMPACT_FRACTION``."""

    __slots__ = ("graph_key", "version", "solutions", "delta_edges",
                 "base_edges", "tiers", "host_variants", "_graph", "_coo",
                 "_n_nodes", "_node_gids", "_device", "_anchor",
                 "_anchor_changed")

    def __init__(self, graph_key, version: int, graph: DeviceGraph,
                 device=None) -> None:
        if graph.host_coo is None:
            raise ValueError("ResidentGraph needs a snapshot with host "
                             "COO arrays (from_coo keeps them)")
        self.graph_key = graph_key
        self.version = int(version)
        self._graph = graph
        self._coo = graph.host_coo
        self._n_nodes = int(graph.n_nodes)
        self._node_gids = graph.node_gids
        # ``device``: a host snapshot is placed there at its first read
        # (a route that never reads it, the mesh's, places nothing)
        self._device = graph.device if device is None else device
        self._anchor = None
        self._anchor_changed: set = set()
        #: algo -> _Solution (the hits and the warm-start seeds)
        self.solutions: dict = {}
        #: (precision, block_bytes) -> TierCSR (the streamed paging plans)
        self.tiers: dict = {}
        #: (by, doubled) -> host ShardedCSR (the splice substrate; each
        #: holds its placements per mesh)
        self.host_variants: dict = {}
        self.delta_edges = 0
        self.base_edges = int(graph.n_edges)

    @property
    def coo(self):
        """The host (src, dst, w) COO of the current generation."""
        return self._coo

    @property
    def n_nodes(self) -> int:
        return self._n_nodes

    @property
    def n_edges(self) -> int:
        return len(self._coo[0])

    @property
    def graph(self) -> DeviceGraph:
        """The snapshot, rebuilt from the COO on its first read after a
        delta (``from_coo``, then placed as the first one was), with the
        refresh lineage; a rebuild's seconds are the ``delta.snapshot_s``
        summary.  A host snapshot given with a ``device`` is placed at its
        first read."""
        if self._graph is not None and self._graph.device is None \
                and self._device is not None:
            self._graph = self._graph.to_device(self._device)
        if self._graph is None:
            t0 = time.perf_counter()
            src, dst, w = self._coo
            g = from_coo(src.astype(np.int64), dst.astype(np.int64),
                         np.asarray(w, dtype=np.float32),
                         n_nodes=self._n_nodes, node_gids=self._node_gids)
            if self._device is not None:
                g = g.to_device(self._device)
            if self._anchor is not None:
                # DeviceGraph is frozen; bypass its setattr guard
                object.__setattr__(g, "_delta_ctx", (
                    self._anchor, frozenset(self._anchor_changed)))
            self._graph = g
            global_metrics.observe("delta.snapshot_s",
                                   time.perf_counter() - t0)
        return self._graph

    def ensure_tier(self, precision: str = "f32",
                    block_bytes: int | None = None):
        """The generation's streamed paging plan (ops/tier.py), built once
        from the host COO and then moved by each commit (``apply``
        re-packs only the touched blocks, into the room each row keeps,
        ``TIER_ROW_SLACK``).  Nothing is placed: the blocks stay on the
        host and the streamed fixpoints copy them a sweep at a time."""
        from . import tier as mgtier
        key = (precision, block_bytes)
        t = self.tiers.get(key)
        if t is None:
            src, dst, w = self._coo
            t = mgtier.plan_tier(
                src.astype(np.int64), dst.astype(np.int64),
                np.asarray(w, dtype=np.float32), self._n_nodes,
                precision=precision, block_bytes=block_bytes,
                slack=TIER_ROW_SLACK)
            self.tiers[key] = t
        return t

    # --- sharded variants ----------------------------------------------------

    def ensure_sharded(self, ctx, by: str = "src",
                       doubled: bool = False) -> ShardedCSR:
        """The generation's partition-centric layout placed on ``ctx``
        (parallel/mesh.py): the host layout per (by, doubled) is built
        once from the COO, with ``TIER_ROW_SLACK`` of room a row so that a
        commit fits in place, and kept as the splice substrate; its
        placement is cached per mesh, so an unmoved generation is never
        re-sorted or re-sent.  The seconds of a call are the
        ``delta.sharded_s`` summary, a ``device.transfer`` span and the
        active stage accumulator's ``device_transfer`` (a cached
        placement shows as a near-zero extent)."""
        t0 = time.perf_counter()
        with mgtrace.span("device.transfer") as sp:
            hv = self.host_variants.get((by, doubled))
            if hv is None or hv.n_shards != ctx.n_shards:
                hv = self._reshard(by, doubled, ctx.n_shards)
                self.host_variants[(by, doubled)] = hv
            dev = self._install(ctx, hv)
            if sp:
                sp.set(n_shards=ctx.n_shards, by=by,
                       n_nodes=int(self._n_nodes), resident=True)
        dt = time.perf_counter() - t0
        global_metrics.observe("delta.sharded_s", dt)
        mgstats.record_stage("device_transfer", dt)
        return dev

    def _reshard(self, by, doubled, n_shards) -> ShardedCSR:
        """A fresh sharded variant of the COO (the global sort; counted
        ``delta.resharded_total``, which a commit's splice leaves)."""
        global_metrics.increment("delta.resharded_total")
        src, dst, w = self._coo
        src = src.astype(np.int64)
        dst = dst.astype(np.int64)
        if doubled:
            src, dst = (np.concatenate([src, dst]),
                        np.concatenate([dst, src]))
            w = np.concatenate([w, w])
        return shard_edges(src, dst, w, self._n_nodes, n_shards, by=by,
                           slack=TIER_ROW_SLACK)

    @staticmethod
    def _install(ctx, host_scsr) -> ShardedCSR:
        """``host_scsr`` placed on ``ctx``, cached on the host layout
        itself (one placement a mesh)."""
        cache = getattr(host_scsr, "_placed_cache", None)
        if cache is None:
            cache = {}
            object.__setattr__(host_scsr, "_placed_cache", cache)
        dev = cache.get(ctx.cache_key)
        if dev is None:
            dev = cache[ctx.cache_key] = host_scsr.to_device(ctx)
        return dev

    # --- delta application -------------------------------------------------

    def apply(self, delta: EdgeDelta, ctx=None) -> bool:
        """Advance the generation by one EdgeDelta: splice the COO and
        drop the snapshot (rebuilt lazily); each sharded variant and each
        paging plan moves by the same delta, rewriting only the rows it
        touches (``apply_edge_delta``; a row overflow re-shards that
        variant, or drops the plan, which ``ensure_tier`` rebuilds from
        the COO), and the moved variants are placed again on ``ctx``.  An
        oversized delta, or deltas
        accumulated past ``DELTA_COMPACT_FRACTION`` of the edges, compact
        (``delta.compacted_total``).  False when a removal matches no edge
        (``delta.fallback_rebuild_total``): the caller re-imports.  The
        seconds of each call are the ``delta.apply_s`` summary."""
        t0 = time.perf_counter()
        try:
            return self._apply(delta, ctx)
        finally:
            global_metrics.observe("delta.apply_s", time.perf_counter() - t0)

    def _apply(self, delta: EdgeDelta, ctx) -> bool:
        if delta.n_delta == 0:
            # a property-only bump: the edges stand, every seed stays
            # valid
            self._note_moved(delta)
            global_metrics.increment("delta.applied_total")
            global_metrics.observe("delta.edge_count", 0.0)
            return True
        if delta.n_delta > max(DELTA_MAX_FRACTION * max(self.base_edges, 1),
                               1024):
            return self._compact(delta, why="oversized delta", ctx=ctx)
        if not self._splice(delta):
            return False
        self.delta_edges += delta.n_delta
        self._note_moved(delta)
        if self.delta_edges > DELTA_COMPACT_FRACTION * max(self.base_edges,
                                                           1):
            return self._compact(None, why="accumulated deltas", ctx=ctx)
        self._splice_variants(delta, ctx)
        self._splice_tiers(delta)
        global_metrics.increment("delta.applied_total")
        global_metrics.observe("delta.edge_count", float(delta.n_delta))
        return True

    def _splice(self, delta: EdgeDelta) -> bool:
        new_coo = splice_coo(self._coo, delta, self._n_nodes)
        if new_coo is None:
            global_metrics.increment("delta.fallback_rebuild_total")
            log.warning("delta: splice failed for %s (a removal matches no "
                        "edge): the generation must be re-imported",
                        self.graph_key)
            return False
        g = self._graph
        if g is not None and getattr(g, "_mxu_base_self", False):
            self._anchor, self._anchor_changed = g, set()
        if self._anchor is not None:
            self._anchor_changed.update(
                self._node_gids[delta.touched_nodes()].tolist())
        self._coo = (new_coo[0].astype(np.int32),
                     new_coo[1].astype(np.int32),
                     new_coo[2].astype(np.float32))
        self._graph = None
        return True

    def _splice_variants(self, delta: EdgeDelta, ctx) -> None:
        """Move every sharded variant by ``delta`` (doubled variants by the
        doubled delta) and place the moved ones again."""
        new = {}
        for (by, doubled), hv in self.host_variants.items():
            nv = apply_edge_delta(hv, delta.doubled() if doubled else delta)
            if nv is None:
                global_metrics.increment("delta.compacted_total")
                log.info("delta: variant (%s, doubled=%s) of %s overflowed "
                         "its row capacity: re-sharded", by, doubled,
                         self.graph_key)
                nv = self._reshard(by, doubled, hv.n_shards)
            new[(by, doubled)] = nv
        self._replace_variants(new, ctx)

    def _replace_variants(self, new: dict, ctx) -> None:
        """Keep the moved variants, placed again on ``ctx`` (on any other
        mesh ``ensure_sharded`` places them at their next use)."""
        self.host_variants = new
        if ctx is not None:
            for nv in new.values():
                if nv.n_shards == ctx.n_shards:
                    self._install(ctx, nv)

    def _splice_tiers(self, delta: EdgeDelta) -> None:
        new_tiers = {}
        for key, t in self.tiers.items():
            nt = t.apply_delta(delta)
            if nt is None:
                global_metrics.increment("delta.compacted_total")
                log.info("delta: tier %s of %s overflowed its row capacity: "
                         "dropped for a lazy rebuild", key, self.graph_key)
            else:
                new_tiers[key] = nt
        self.tiers = new_tiers

    def _compact(self, delta, why: str, ctx=None) -> bool:
        """Splice ``delta`` (when given) and restart the accumulation
        count: the COO is exact either way, the next snapshot is built
        from it and its plan follows the DeltaPlan rule; the sharded
        variants are re-sharded from the COO and placed again, the paging
        plans dropped (``ensure_tier`` rebuilds them from the COO)."""
        if delta is not None:
            if not self._splice(delta):
                return False
            self._note_moved(delta)
        self._replace_variants(
            {(by, doubled): self._reshard(by, doubled, hv.n_shards)
             for (by, doubled), hv in self.host_variants.items()}, ctx)
        self.tiers = {}
        self.delta_edges = 0
        self.base_edges = self.n_edges
        global_metrics.increment("delta.compacted_total")
        log.info("delta: compacted generation %s (%s)", self.graph_key, why)
        return True

    def _note_moved(self, delta: EdgeDelta) -> None:
        self.version = int(delta.version)
        for sol in self.solutions.values():
            sol.monotone_ok = sol.monotone_ok and delta.adds_only

    # --- solutions ---------------------------------------------------------

    def note_solution(self, algo: str, params_key: tuple, x: np.ndarray,
                      err: float | None = None, iters: int | None = None,
                      max_iterations: int | None = None) -> None:
        self.solutions[algo] = _Solution(
            x=np.asarray(x), version=self.version,
            params_key=tuple(params_key), monotone_ok=True, iters=iters,
            err=err, max_iterations=max_iterations)

    def cached_result(self, algo: str, params_key: tuple,
                      max_iterations=None):
        """The stored solution itself when the generation has not moved
        since it was computed and the parameters match: a repeated
        request gets the same bytes."""
        sol = self.solutions.get(algo)
        if sol is None or sol.params_key != tuple(params_key) \
                or sol.version != self.version:
            return None
        if max_iterations is not None and sol.max_iterations is not None \
                and int(max_iterations) != int(sol.max_iterations):
            return None
        return sol

    def warm_x0(self, algo: str, params_key: tuple):
        """(x0, reason): x0 None is a cold start; a seed the contract
        refuses is dropped, counted and logged here."""
        sol = self.solutions.get(algo)
        if sol is None or sol.params_key != tuple(params_key):
            return None, "no_seed"
        warm, reason = warm_start_decision(algo, sol.monotone_ok)
        if not warm:
            record_cold_start(algo, reason)
            self.solutions.pop(algo, None)
            return None, reason
        return sol.x, reason


class ResidentRegistry:
    """The bounded LRU of ResidentGraphs by graph key.  Callers
    serialize through one dispatcher; ``peek`` (no LRU move) is the one
    read made outside it, an estimate's."""

    def __init__(self, capacity: int = 8) -> None:
        self.capacity = capacity
        self._gens: "OrderedDict[object, ResidentGraph]" = OrderedDict()

    def get(self, graph_key) -> ResidentGraph | None:
        gen = self._gens.get(graph_key)
        if gen is not None:
            self._gens.move_to_end(graph_key)
        return gen

    def peek(self, graph_key) -> ResidentGraph | None:
        return self._gens.get(graph_key)

    def put(self, gen: ResidentGraph) -> None:
        self._gens[gen.graph_key] = gen
        self._gens.move_to_end(gen.graph_key)
        while len(self._gens) > self.capacity:
            self._gens.popitem(last=False)
        self._gauge()

    def pop(self, graph_key) -> None:
        self._gens.pop(graph_key, None)
        self._gauge()

    def items(self) -> list:
        return list(self._gens.items())

    def __len__(self) -> int:
        return len(self._gens)

    def _gauge(self) -> None:
        global_metrics.set_gauge("delta.resident_generations",
                                 float(len(self._gens)))
