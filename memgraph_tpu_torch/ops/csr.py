"""Graph snapshot in CSR + CSC form, built on the host and placed as torch
tensors on a device.

Port of memgraph_tpu/ops/csr.py (``DeviceGraph``, ``from_coo``).  Node ids
are dense; ``n_nodes``/``n_edges`` are padded up to powers of two, and the
padding edges are zero-weight self loops on a sink row (index
``n_nodes``), so segment reductions ignore them.  ``from_coo`` takes the
native counting-sort builder (native/csr_builder.cpp) first and the numpy
lexsort path where that builder is unavailable; both give the same arrays.

Storage snapshots (port of ``export_csr``, ``export_csr_delta`` and
``GraphCache``, memgraph_tpu/ops/csr.py): the port reads a storage through
a duck-typed **source**, so that it imports nothing of the storage that
owns the graph.  A source gives

  ``storage``            the object the cache keys on (weakly: snapshots
                         die with it)
  ``version``            the view's topology snapshot (a storage
                         transaction's ``topology_snapshot``, else the
                         storage's ``topology_version``)
  ``changes_between(v_from, v_to)``
                         the frozenset of vertex gids changed in versions
                         (v_from, v_to], or a ``ChangeLogUnknowable``
                         (falsy) when its change log cannot say
  ``vertices(label_filter)``
                         the visible vertex gids (at the view's
                         ``View.OLD``), in the order the storage walks
                         them: that order fixes the dense indices
  ``edges(weight_property, edge_type_filter)``
                         (src gids, dst gids, raw weights) of the visible
                         edges of the wanted types, in the storage's edge
                         order; raw weights are the property's values (a
                         float array, or any values ``_coerce_weight``
                         turns into floats), or None when the edges carry
                         no such property
  ``incident(gid, weight_property, edge_type_filter, label_filter)``
                         None when the vertex is gone or is not in the
                         view; else (out gids, out raw weights, in gids,
                         in raw weights): the far ends of its visible out-
                         and in-edges of the wanted types, from the
                         storage's own state of the vertex (not a
                         session's fine-grained filters: a cached
                         snapshot is every session's)
  ``vertex_property(name, gids)``
                         None when the storage knows no property ``name``;
                         else its value on each vertex with a gid in
                         ``gids`` (None where the vertex lacks it or is
                         not visible), one a gid in order: a sequence of
                         values, or a numpy array of them (a 2-D array
                         when every value is a numeric list of one
                         length); the dense paths' procedures (node
                         features, vector indexes) read either form
                         through ``property_rows``
  ``vertex_records(gids)``
                         for the text procedures (procedures/
                         embeddings_module.py): each vertex's (label
                         names, {property name: value}) as the storage
                         holds them, one a gid in order, None where the
                         vertex is not visible

``memgraph_tpu_torch.northstar.CooSource`` is one (a versioned COO graph);
the tests hold an adapter of the JAX package's storage against it.
"""

from __future__ import annotations

import logging
import threading
import weakref
from collections import Counter
from dataclasses import dataclass, field, fields
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..utils.metrics import global_metrics

_ARRAYS = ("row_ptr", "col_idx", "src_idx", "weights", "csc_src", "csc_dst",
           "csc_weights", "out_degree", "col_ptr")


def _bucket(n: int, minimum: int = 8) -> int:
    """Round up to the next power of two."""
    n = max(n, minimum)
    return 1 << (n - 1).bit_length()


@dataclass(frozen=True)
class DeviceGraph:
    """Immutable CSR+CSC snapshot.  Arrays are numpy (a host graph, from
    ``from_coo``) or torch tensors on one device (after ``to_device``).

    CSR layout (edges lexsorted by (src, dst)):
      row_ptr:    (n_pad+1,) int32 — CSR offsets
      col_idx:    (e_pad,)   int32 — destination node per edge
      src_idx:    (e_pad,)   int32 — source node per edge (COO mirror)
      weights:    (e_pad,)   float32 — edge weight (1.0 default, 0.0 padding)
    CSC layout (same edges lexsorted by (dst, src)), for the pull-style
    segment reductions:
      csc_src / csc_dst: (e_pad,) int32
      csc_weights:       (e_pad,) float32
      col_ptr:    (n_pad+1,) int32 — CSC run offsets: the edges into node j
                  are [col_ptr[j], col_ptr[j+1]); the padding edges form
                  the sink's run [n_edges, e_pad), so the runs cover every
                  CSC edge in order (the deterministic segment sum of
                  ops/segment_cuda.py walks them).  ``row_ptr``'s runs
                  hold the true edges only.
    out_degree: (n_pad,) float32 — true out-degrees (0 for padding rows)
    n_nodes / n_edges: true counts;  n_pad / e_pad: padded counts
    node_gids:  (n_nodes,) int64 host array — dense index -> storage gid
    host_coo:   (src int32, dst int32, w float32) host arrays of the true
                edges in input order, or None — kept so that a successor
                snapshot can diff its edges against this one for the
                O(delta) MXU plan refresh (spmv_mxu.DeltaPlan) without
                copying the edges back from the device
    longest_csr_run / longest_csc_run: the longest run of ``row_ptr`` /
                ``csc_runs()`` (the largest out- / in-degree), counted
                once on the host when the graph is built; the run sum
                (ops/segment_cuda.py) takes its launch shape from it
    """

    row_ptr: object
    col_idx: object
    src_idx: object
    weights: object
    csc_src: object
    csc_dst: object
    csc_weights: object
    out_degree: object
    col_ptr: object
    n_nodes: int
    n_edges: int
    n_pad: int
    e_pad: int
    node_gids: np.ndarray
    gid_to_idx: dict = field(repr=False, hash=False, compare=False)
    host_coo: tuple = field(default=None, repr=False, hash=False,
                            compare=False)
    longest_csr_run: Optional[int] = None
    longest_csc_run: Optional[int] = None

    @property
    def device(self) -> Optional[torch.device]:
        """The device the arrays live on, or None for a host graph."""
        return (self.row_ptr.device if isinstance(self.row_ptr, torch.Tensor)
                else None)

    def csc_runs(self):
        """``col_ptr`` without the padding edges: the CSC runs of the true
        edges, as ``row_ptr`` gives the CSR ones.  The sink's run of
        padding edges would be one thread's serial walk of e_pad -
        n_edges edges in the run sum (ops/segment_cuda.py); they carry
        weight 0 into the sink row, which every fixpoint masks, so
        leaving them out leaves every true row as it was."""
        if isinstance(self.col_ptr, torch.Tensor):
            return self.col_ptr.clamp(max=self.n_edges)
        return np.minimum(self.col_ptr, self.n_edges)

    def host_edges(self):
        """(src, dst, w) numpy arrays of the true edges, in CSR order."""
        def host(a):
            return a.cpu().numpy() if isinstance(a, torch.Tensor) else a
        n = self.n_edges
        return (host(self.src_idx)[:n], host(self.col_idx)[:n],
                host(self.weights)[:n])

    def to_device(self, device=None) -> "DeviceGraph":
        """Place every array as a torch tensor on ``device`` (default: the
        card; see memgraph_tpu_torch.device.resolve_device)."""
        dev = resolve_device(device)
        placed = {}
        for name in _ARRAYS:
            a = getattr(self, name)
            if not isinstance(a, torch.Tensor):
                a = torch.from_numpy(np.ascontiguousarray(a))
            placed[name] = a.to(dev)
        kept = {f.name: getattr(self, f.name) for f in fields(self)
                if f.name not in _ARRAYS}
        return DeviceGraph(**placed, **kept)


def from_coo(src: np.ndarray, dst: np.ndarray,
             weights: Optional[np.ndarray] = None,
             n_nodes: Optional[int] = None,
             node_gids: Optional[np.ndarray] = None,
             pad: bool = True) -> DeviceGraph:
    """Build a host-side DeviceGraph from COO edge arrays (dense node ids)."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    n_edges = len(src)
    if n_nodes is None:
        n_nodes = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1)
    if n_edges and (min(src.min(), dst.min()) < 0
                    or max(src.max(), dst.max()) >= n_nodes):
        raise ValueError(
            f"edge endpoint id out of range [0, {n_nodes}) in COO input")
    if weights is None:
        weights = np.ones(n_edges, dtype=np.float32)
    else:
        weights = np.asarray(weights, dtype=np.float32)

    n_pad = _bucket(n_nodes + 1) if pad else n_nodes + 1
    e_pad = _bucket(n_edges) if pad else max(n_edges, 1)
    from .native import build_csr_csc_native
    native = (build_csr_csc_native(src, dst, weights, n_nodes, n_pad, e_pad)
              if n_edges else None)
    if native is not None:
        row_ptr, out_degree = native["row_ptr"], native["out_degree"]
        src_full, dst_full, w_full = (native["csr_src"], native["csr_dst"],
                                      native["csr_w"])
        csc_src, csc_dst, csc_w = (native["csc_src"], native["csc_dst"],
                                   native["csc_w"])
        col_ptr = native["col_ptr"]
    else:
        (row_ptr, src_full, dst_full, w_full, csc_src, csc_dst, csc_w,
         out_degree, col_ptr) = _csr_csc_numpy(src, dst, weights, n_nodes,
                                               n_pad, e_pad)

    if node_gids is None:
        node_gids = np.arange(n_nodes, dtype=np.int64)
    node_gids = np.asarray(node_gids, dtype=np.int64)
    gid_to_idx = dict(zip(node_gids.tolist(), range(len(node_gids))))

    return DeviceGraph(row_ptr=row_ptr, col_idx=dst_full, src_idx=src_full,
                       weights=w_full,
                       csc_src=csc_src, csc_dst=csc_dst, csc_weights=csc_w,
                       out_degree=out_degree, col_ptr=col_ptr,
                       n_nodes=n_nodes, n_edges=n_edges,
                       n_pad=n_pad, e_pad=e_pad,
                       node_gids=node_gids, gid_to_idx=gid_to_idx,
                       host_coo=(src.astype(np.int32), dst.astype(np.int32),
                                 weights),
                       longest_csr_run=_longest_run(row_ptr),
                       longest_csc_run=_longest_run(
                           np.minimum(col_ptr, n_edges)))


def _longest_run(ptr) -> int:
    """The longest run of host offsets ``ptr``."""
    return int(np.diff(ptr).max(initial=0))


def _csr_csc_numpy(src, dst, weights, n_nodes, n_pad, e_pad):
    """The numpy path of ``from_coo``: (row_ptr, csr src, csr dst, csr w,
    csc src, csc dst, csc w, out_degree, col_ptr), padded."""
    n_edges = len(src)
    # padding edges: sink->sink self loops with zero weight; the sink is the
    # extra padding row n_nodes (guaranteed to exist since n_pad >= n_nodes+1)
    sink = n_nodes
    # lexicographic (src, dst) order: rows contiguous AND sorted by dst
    order = np.lexsort((dst, src))
    s_sorted = src[order]
    d_sorted = dst[order]
    w_sorted = weights[order]

    src_full = np.full(e_pad, sink, dtype=np.int32)
    dst_full = np.full(e_pad, sink, dtype=np.int32)
    w_full = np.zeros(e_pad, dtype=np.float32)
    src_full[:n_edges] = s_sorted
    dst_full[:n_edges] = d_sorted
    w_full[:n_edges] = w_sorted

    # CSC mirror: (dst, src)-sorted. Reuse the (src, dst)-sorted arrays
    # with one single-key stable sort — stability preserves the src order
    # within equal dst, giving (dst, src) order at half the sort cost.
    corder = np.argsort(d_sorted, kind="stable")
    csc_src = np.full(e_pad, sink, dtype=np.int32)
    csc_dst = np.full(e_pad, sink, dtype=np.int32)
    csc_w = np.zeros(e_pad, dtype=np.float32)
    csc_src[:n_edges] = s_sorted[corder]
    csc_dst[:n_edges] = d_sorted[corder]
    csc_w[:n_edges] = w_sorted[corder]

    counts = np.bincount(s_sorted, minlength=n_pad).astype(np.int64)
    row_ptr = np.zeros(n_pad + 1, dtype=np.int32)
    np.cumsum(counts, out=row_ptr[1:])

    # CSC runs: the sink's run holds the padding edges, later runs are empty
    col_ptr = np.full(n_pad + 1, e_pad, dtype=np.int32)
    col_ptr[0] = 0
    np.cumsum(np.bincount(d_sorted, minlength=n_nodes)[:n_nodes],
              out=col_ptr[1:n_nodes + 1])

    out_degree = np.zeros(n_pad, dtype=np.float32)
    out_degree[:n_nodes] = np.bincount(
        src, minlength=n_nodes).astype(np.float32)[:n_nodes]
    return (row_ptr, src_full, dst_full, w_full, csc_src, csc_dst, csc_w,
            out_degree, col_ptr)


# ---------------------------------------------------------------------------
# storage snapshots: export, delta export and the snapshot cache
# ---------------------------------------------------------------------------

log = logging.getLogger(__name__)


class ChangeLogUnknowable:
    """A source's verdict that its bounded change log cannot say what
    changed in (v_from, v_to]: the log wrapped past v_from
    (``reason="log_wrapped"``) or a bump in the range recorded no gids
    (``reason="untracked_bump"``).  Falsy, so ``if changed:`` treats it as
    an unusable delta; consumers branch on it and rebuild in full."""

    __slots__ = ("reason", "oldest_logged_version")

    def __init__(self, reason: str, oldest_logged_version: int) -> None:
        self.reason = reason
        self.oldest_logged_version = oldest_logged_version

    def __bool__(self) -> bool:
        return False

    def __repr__(self) -> str:
        return (f"ChangeLogUnknowable({self.reason!r}, "
                f"oldest_logged_version={self.oldest_logged_version})")


def _coerce_weight(w) -> float:
    """Edge-weight property -> float; non-numeric/missing -> 1.0."""
    return (float(w) if isinstance(w, (int, float))
            and not isinstance(w, bool) else 1.0)


def _weights(raw) -> np.ndarray:
    """float32 weights of raw property values: a numeric array as it is,
    anything else value by value through ``_coerce_weight``."""
    if isinstance(raw, np.ndarray) and raw.dtype.kind in "iuf":
        return raw.astype(np.float32)
    return np.asarray([_coerce_weight(w) for w in raw], dtype=np.float32)


def _numeric_list(value):
    """A property value as a list of floats when it is a non-empty list
    of numbers (bools are not numbers), else None."""
    if isinstance(value, (list, tuple)) and value and \
            all(isinstance(x, (int, float)) and not isinstance(x, bool)
                for x in value):
        return [float(x) for x in value]
    return None


def property_rows(values):
    """(matrix, kept) of a ``vertex_property`` read, in either of its
    forms: ``kept[i]`` is True where ``values[i]`` is a non-empty list of
    numbers of the dominant length (the most frequent; the first seen on
    a tie), and ``matrix`` holds those values as float32 rows in order,
    or is None when no value is kept."""
    if isinstance(values, np.ndarray) and values.ndim == 2 \
            and values.dtype.kind in "iuf":
        if values.shape[1] == 0:
            return None, np.zeros(len(values), dtype=bool)
        return values.astype(np.float32), np.ones(len(values), dtype=bool)
    vectors = [_numeric_list(v) for v in values]
    lengths = Counter(len(v) for v in vectors if v is not None)
    if not lengths:
        return None, np.zeros(len(vectors), dtype=bool)
    dim = lengths.most_common(1)[0][0]
    kept = np.asarray([v is not None and len(v) == dim for v in vectors],
                      dtype=bool)
    return np.asarray([v for v, k in zip(vectors, kept) if k],
                      dtype=np.float32), kept


def _gid_index(node_gids):
    """A lookup of dense indices by gid (``_dense_ids``): None when the
    gids are 0..n-1 in order (each its own index), else the gids' sort
    order and the sorted gids."""
    n = len(node_gids)
    if n == 0 or (node_gids[0] == 0 and node_gids[-1] == n - 1
                  and bool((np.diff(node_gids) == 1).all())):
        return None
    order = np.argsort(node_gids, kind="stable")
    return order, node_gids[order]


def _dense_ids(gids, n: int, index) -> np.ndarray:
    """The dense index of each gid among n node gids, -1 where it has
    none (``index`` from ``_gid_index``)."""
    gids = np.asarray(gids, dtype=np.int64).reshape(-1)
    if n == 0 or len(gids) == 0:
        return np.full(len(gids), -1, dtype=np.int64)
    if index is None:
        return np.where((gids >= 0) & (gids < n), gids, -1)
    order, ranked = index
    pos = np.minimum(np.searchsorted(ranked, gids), n - 1)
    return np.where(ranked[pos] == gids, order[pos], -1)


def export_csr(source, weight_property=None, label_filter=None,
               edge_type_filter=None, pad: bool = True,
               to_device: bool = True, device=None) -> DeviceGraph:
    """The source's visible graph as a DeviceGraph: its vertices in the
    source's order, its edges between them in the source's edge order
    (an edge with an endpoint outside the view is left out), weights
    coerced to float32 (1.0 where none).  Placed on ``device`` (default:
    the card) unless ``to_device`` is False."""
    node_gids = np.asarray(list(source.vertices(label_filter)),
                           dtype=np.int64)
    e_src, e_dst, raw = source.edges(weight_property, edge_type_filter)
    index = _gid_index(node_gids)
    si = _dense_ids(e_src, len(node_gids), index)
    di = _dense_ids(e_dst, len(node_gids), index)
    keep = (si >= 0) & (di >= 0)
    weights = (None if weight_property is None or raw is None
               else _weights(raw)[keep])
    g = from_coo(si[keep], di[keep], weights, n_nodes=len(node_gids),
                 node_gids=node_gids, pad=pad)
    return g.to_device(device) if to_device else g


def export_csr_delta(prev: DeviceGraph, source, changed_gids,
                     weight_property=None, label_filter=None,
                     edge_type_filter=None, pad: bool = True,
                     to_device: bool = True, device=None):
    """O(changed) re-export: splice the changed vertices' edges into the
    previous snapshot's host COO instead of walking every edge, then one
    ``from_coo``.  Valid only while the view's vertex set is unchanged:
    returns None (the caller exports in full) when a changed vertex is
    gone, joined or left the view, or has an edge to a vertex the
    previous snapshot lacks.  The splice keeps the edges with neither
    endpoint changed, appends each changed vertex's out-edges and its
    in-edges from unchanged sources, so every edge comes once and the
    arrays are ``export_csr``'s."""
    if prev.host_coo is None:
        return None
    has_w = weight_property is not None
    changed = list(changed_gids)
    bitmap = np.zeros(prev.n_nodes, dtype=bool)
    idxs, out_g, in_g, out_w, in_w = [], [], [], [], []
    for gid in changed:
        inc = source.incident(gid, weight_property, edge_type_filter,
                              label_filter)
        idx = prev.gid_to_idx.get(gid)
        if inc is None or idx is None:
            return None               # gone, joined or left the view
        bitmap[idx] = True
        idxs.append(idx)
        out_g.append(np.asarray(inc[0], dtype=np.int64).reshape(-1))
        in_g.append(np.asarray(inc[2], dtype=np.int64).reshape(-1))
        if has_w:
            out_w.append(_weights(_raw(inc[1], len(out_g[-1]))))
            in_w.append(_weights(_raw(inc[3], len(in_g[-1]))))
    index = _gid_index(prev.node_gids)
    di = _dense_ids(_cat(out_g, np.int64), prev.n_nodes, index)
    si = _dense_ids(_cat(in_g, np.int64), prev.n_nodes, index)
    if (di < 0).any() or (si < 0).any():
        return None                   # new endpoint: node set changed
    # every out-edge of a changed vertex comes once; an edge into it comes
    # with its in-edges only from an unchanged source.  Vertex by vertex:
    # its out-edges, then those in-edges
    idxs = np.asarray(idxs, dtype=np.int64)
    rank = np.arange(len(idxs), dtype=np.int64)
    n_out = [len(a) for a in out_g]
    n_in = [len(a) for a in in_g]
    kept = ~bitmap[si]
    order = np.argsort(np.concatenate([
        2 * np.repeat(rank, n_out), (2 * np.repeat(rank, n_in) + 1)[kept]]),
        kind="stable")
    fresh_src = np.concatenate([np.repeat(idxs, n_out), si[kept]])[order]
    fresh_dst = np.concatenate([di, np.repeat(idxs, n_in)[kept]])[order]
    fresh_w = (np.concatenate([_cat(out_w, np.float32),
                               _cat(in_w, np.float32)[kept]])[order]
               if has_w else None)
    p_src, p_dst, p_w = prev.host_coo
    keep = ~(bitmap[p_src] | bitmap[p_dst])
    src = np.concatenate([p_src[keep].astype(np.int64), fresh_src])
    dst = np.concatenate([p_dst[keep].astype(np.int64), fresh_dst])
    weights = (np.concatenate([p_w[keep], fresh_w]).astype(np.float32)
               if has_w else None)
    g = from_coo(src, dst, weights, n_nodes=prev.n_nodes,
                 node_gids=prev.node_gids, pad=pad)
    return g.to_device(device) if to_device else g


def _cat(arrays, dtype) -> np.ndarray:
    """The arrays end to end (empty of ``dtype`` when there are none)."""
    return np.concatenate([np.zeros(0, dtype), *arrays])


def _raw(values, n):
    """Raw weights as a source gave them; None (no such property) is 1.0
    for each of the n edges."""
    return [None] * n if values is None else values


class GraphCache:
    """Per-storage cache of CSR snapshots keyed by (topology version,
    weight property, label filter, edge types, device).

    A snapshot is valid while the view's version is unchanged.  A new
    version is exported from the newest snapshot strictly older than the
    view by ``export_csr_delta`` when the source's change log knows what
    changed and the change is small (at most max(1024, n_nodes // 5)
    vertices); an unknowable gap, a large change or any failure of the
    delta export gives a full export.  A snapshot whose view has an
    earlier snapshot with a full MXU plan (``_mxu_base_self``, set by
    PageRank) is marked ``_delta_ctx = (that snapshot, changed gids)``,
    which PageRank refreshes from in O(delta) (ops/pagerank.py).  The
    device is part of the key, in ``resolve_device``'s form: "cuda" and
    "cuda:0" share a snapshot, the CPU and the card do not.  Snapshots
    die with their storage (a weak key).

    ``counters``: "export.full" and "export.delta" (snapshots made each
    way); a full export forced by an unknowable change log also counts
    ``delta.fallback_rebuild_total`` in ``utils.metrics.global_metrics``."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cache = weakref.WeakKeyDictionary()
        self.counters = {"export.full": 0, "export.delta": 0}

    def get(self, source, weight_property=None, label_filter=None,
            edge_type_filter=None, device=None) -> DeviceGraph:
        storage = source.storage
        dev = resolve_device(device)
        etf = (tuple(sorted(edge_type_filter))
               if edge_type_filter is not None else None)
        version = source.version
        key = (version, weight_property, label_filter, etf, dev)
        base_key = ("base", weight_property, label_filter, etf, dev)
        newest = None
        with self._lock:
            per_storage = self._cache.get(storage)
            hit = per_storage.get(key) if per_storage else None
            base = per_storage.get(base_key) if per_storage else None
            for k, v in (per_storage or {}).items():
                if k[0] == "base" or k[1:] != key[1:]:
                    continue
                # base anchor: the newest snapshot with a full MXU plan
                # (_mxu_base_self post-dates its get(), so scan live)
                if getattr(v, "_mxu_base_self", False) \
                        and (base is None or base[0] < k[0]):
                    base = (k[0], v)
                # delta-export base: the newest snapshot strictly older
                # than this view (a newer one may hold commits it cannot
                # see)
                if k[0] < version and (newest is None
                                       or k[0] > newest[0]):
                    newest = (k[0], v)
        if hit is not None:
            return hit
        g = None
        if newest is not None:
            changed = source.changes_between(newest[0], version)
            if isinstance(changed, ChangeLogUnknowable):
                # a silently partial delta would cache a wrong snapshot
                global_metrics.increment("delta.fallback_rebuild_total")
                log.info("change log unknowable (%s) for versions (%d, %d]; "
                         "full CSR export", changed.reason, newest[0],
                         version)
                changed = None
            if changed is not None and \
                    len(changed) <= max(1024, newest[1].n_nodes // 5):
                try:
                    g = export_csr_delta(
                        newest[1], source, changed,
                        weight_property=weight_property,
                        label_filter=label_filter,
                        edge_type_filter=edge_type_filter, device=dev)
                except Exception:  # noqa: BLE001 — any doubt: full export
                    log.debug("delta CSR export failed; falling back to a "
                              "full export", exc_info=True)
                    g = None
        path = "export.delta" if g is not None else "export.full"
        if g is None:
            g = export_csr(source, weight_property=weight_property,
                           label_filter=label_filter,
                           edge_type_filter=edge_type_filter, device=dev)
        if base is not None:
            base_version, base_g = base
            changed = source.changes_between(base_version, version)
            # an unknowable gap anchors nothing: the refresh would plan
            # from an incomplete diff
            if isinstance(changed, frozenset) \
                    and getattr(base_g, "_mxu_state", None) is not None:
                object.__setattr__(g, "_delta_ctx", (base_g, changed))
        with self._lock:
            self.counters[path] += 1
            # keep base anchors, this version's variants and newer
            # versions (an older view must not evict a newer snapshot);
            # drop strictly older versions
            per = self._cache.get(storage) or {}
            kept = {k: v for k, v in per.items()
                    if k[0] == "base" or k[0] >= version}
            # an older snapshot becomes the base anchor once a full plan
            # was built on it
            for k, v in per.items():
                if k[0] not in ("base", version) \
                        and k[1:] == key[1:] \
                        and getattr(v, "_mxu_base_self", False):
                    cur_base = kept.get(base_key)
                    if cur_base is None or cur_base[0] < k[0]:
                        kept[base_key] = (k[0], v)
            kept[key] = g
            self._cache[storage] = kept
        return g

    def clear(self) -> None:
        with self._lock:
            self._cache = weakref.WeakKeyDictionary()


GLOBAL_GRAPH_CACHE = GraphCache()


# ---------------------------------------------------------------------------
# partition-centric blocked layout (host half)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShardedCSR:
    """Partition-centric (owner block, dst block)-blocked edge layout.

    Port of the host half of memgraph_tpu/ops/csr.py's ``ShardedCSR``:
    vertices are split into ``n_shards`` contiguous blocks of ``block``
    ids (padded to n_pad2 = n_shards * block, so ``n_nodes % n_shards``
    just pads the last block); every edge is owned by the block of its
    ``by`` endpoint ("src" for the pull-style SpMV, "dst" for label
    propagation).  Within a row, edges are (dst, src)-sorted, so a row is
    a concatenation of (owner, dst-block) runs: the run into block q is
    ``block_ptr[p, q]:block_ptr[p, q+1]``.

    On the host the arrays are numpy, stacked (n_shards, per): the
    streamed tier (ops/tier.py) encodes each row as one host-pinned block,
    and a resident generation splices commits into them (ops/delta.py
    ``apply_edge_delta``).  ``to_device(ctx)`` places them on a mesh
    (parallel/mesh.py): ``src``, ``dst`` and ``weights`` become tuples of
    one tensor a shard, row p on shard p's device, and ``runs`` holds
    each row's run data, built on the host once a placement:

      ``dst_ptr``      (n_pad2 + 1,) int32: the real edges into vertex j
                       are [dst_ptr[j], dst_ptr[j+1]) (K1's runs; the
                       padding edges lie in no run)
      ``dst_longest``  the longest of those runs (K1's launch shape)
      ``rc``           the row's real edges (the rest is padding)
      ``src_longest``  for a src-owned row, the largest local out-degree
                       (K1's launch shape for the weight sums)
      ``local_src``    for a src-owned row, src - the block base (int32)

    ``host`` keeps the host layout a placement came from, so ``refresh``
    re-places it after a device loss.

    Padding edges: src = the row's block base, dst = n_nodes (the sink
    row, always < n_pad2), weight 0, at the row's tail so dst stays
    sorted."""

    src: object              # (P, per) int32, or a tensor a shard
    dst: object              # (P, per) int32, or a tensor a shard
    weights: object          # (P, per) float32, or a tensor a shard
    block_ptr: np.ndarray    # (P, P+1) int32: (p, q)-run boundaries
    n_nodes: int
    n_edges: int
    n_shards: int
    block: int               # vertices a block
    n_pad2: int              # n_shards * block
    per: int                 # edges a row (padding included)
    by: str                  # "src" | "dst": the owning endpoint
    runs: tuple = field(default=None, repr=False, compare=False)
    host: object = field(default=None, repr=False, compare=False)
    ctx_key: tuple = field(default=None, repr=False, compare=False)

    @property
    def placed(self) -> bool:
        return not isinstance(self.src, np.ndarray)

    def to_device(self, ctx) -> "ShardedCSR":
        """The rows placed one a shard of ``ctx`` (each uploaded once,
        pinned), with their run data; a placed layout is returned as it
        is."""
        if self.placed:
            return self
        sink = self.n_nodes
        bounds = np.arange(self.n_pad2 + 1, dtype=np.int64)
        runs, ptrs, local = [], [], []
        for p in range(self.n_shards):
            dst = self.dst[p]
            rc = int(np.searchsorted(dst, sink, side="left"))
            ptr = np.searchsorted(dst[:rc], bounds).astype(np.int32)
            r = {"rc": rc, "dst_longest": int(np.diff(ptr).max(initial=0))}
            if self.by == "src":
                loc = (self.src[p] - np.int32(p * self.block)).astype(
                    np.int32)
                local.append(loc)
                r["src_longest"] = int(np.bincount(
                    loc[:rc], minlength=1).max())
            runs.append(r)
            ptrs.append(ptr)
        on = ctx.put_edge_blocks(np.stack(ptrs))
        loc_on = ctx.put_edge_blocks(np.stack(local)) if local else None
        for p, r in enumerate(runs):
            r["dst_ptr"] = on[p]
            if loc_on is not None:
                r["local_src"] = loc_on[p]
        placed = ShardedCSR(
            src=ctx.put_edge_blocks(self.src),
            dst=ctx.put_edge_blocks(self.dst),
            weights=ctx.put_edge_blocks(self.weights),
            block_ptr=self.block_ptr, n_nodes=self.n_nodes,
            n_edges=self.n_edges, n_shards=self.n_shards, block=self.block,
            n_pad2=self.n_pad2, per=self.per, by=self.by,
            runs=tuple(runs), host=self, ctx_key=ctx.cache_key)
        ctx.synchronize()
        return placed

    def refresh(self, ctx) -> "ShardedCSR":
        """Place the host layout again (the device-lost recovery hook of
        parallel/checkpoint.py: the rows on the card are gone); a host
        layout is returned as it is."""
        if not self.placed:
            return self
        return self.host.to_device(ctx)


def _ceil_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def shard_edges(src, dst, weights, n_nodes: int, n_shards: int,
                by: str = "src", block_multiple: int = 8,
                slack: float = 0.0) -> ShardedCSR:
    """Block COO edges partition-centrically over ``n_shards`` rows (the
    reference's arrays, one for one).  ``block`` is rounded up to
    ``block_multiple``.  ``slack`` (port only; 0: the reference's layout)
    widens every row by that share of the fullest row, so that edges a
    commit adds fit in place (ops/delta.py ``apply_edge_delta``)."""
    if by not in ("src", "dst"):
        raise ValueError(f"by must be 'src' or 'dst', got {by!r}")
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    n_edges = len(src)
    w = (np.ones(n_edges, dtype=np.float32) if weights is None
         else np.asarray(weights, dtype=np.float32))
    # +1: the sink row n_nodes must exist inside the padded vertex space
    block = _ceil_multiple(max((n_nodes + 1 + n_shards - 1) // n_shards, 1),
                           block_multiple)
    n_pad2 = n_shards * block

    owner = (src if by == "src" else dst) // block
    if n_shards * n_pad2 * n_pad2 < 2**62:
        # the lexsort's (owner, dst, src) order as one stable int64 sort
        # (torch's sorts on every host core; a stable order is unique)
        order = torch.sort(torch.from_numpy(
            (owner * n_pad2 + dst) * n_pad2 + src), stable=True)[1].numpy()
    else:
        order = np.lexsort((src, dst, owner))
    s_s, d_s, w_s = src[order], dst[order], w[order]
    counts = np.bincount(owner, minlength=n_shards)
    fullest = int(counts.max(initial=0))
    if slack > 0:
        fullest += int(np.ceil(fullest * slack))
    per = _ceil_multiple(max(fullest, 1), block_multiple)

    src_b = np.empty((n_shards, per), dtype=np.int32)
    dst_b = np.full((n_shards, per), n_nodes, dtype=np.int32)
    w_b = np.zeros((n_shards, per), dtype=np.float32)
    # padding src gathers in bounds on its own block: the block base
    src_b[:] = (np.arange(n_shards, dtype=np.int32) * block)[:, None]
    offsets = np.concatenate([[0], np.cumsum(counts)])
    bounds = np.arange(n_shards + 1, dtype=np.int64) * block
    block_ptr = np.empty((n_shards, n_shards + 1), dtype=np.int32)
    for p in range(n_shards):
        lo, hi = offsets[p], offsets[p + 1]
        src_b[p, :hi - lo] = s_s[lo:hi]
        dst_b[p, :hi - lo] = d_s[lo:hi]
        w_b[p, :hi - lo] = w_s[lo:hi]
        block_ptr[p] = np.searchsorted(dst_b[p], bounds)
    return ShardedCSR(src=src_b, dst=dst_b, weights=w_b,
                      block_ptr=block_ptr, n_nodes=n_nodes,
                      n_edges=n_edges, n_shards=n_shards, block=block,
                      n_pad2=n_pad2, per=per, by=by)


_sharded_csr_guard = threading.Lock()


def shard_csr(graph: DeviceGraph, ctx, by: str = "src",
              doubled: bool = False) -> ShardedCSR:
    """The partition-centric ShardedCSR of ``graph`` placed on ``ctx``,
    cached on the (immutable) snapshot per (mesh, by, doubled): repeated
    mesh calls on an unchanged graph pay the blocking and the transfer
    once.  ``doubled=True`` concatenates both edge directions before
    blocking (the undirected view label propagation iterates over)."""
    key = (ctx.cache_key, by, doubled)
    cache = getattr(graph, "_sharded_csr", None)
    if cache is not None and key in cache:
        return cache[key]
    with _sharded_csr_guard:
        cache = getattr(graph, "_sharded_csr", None)
        if cache is None:
            cache = {}
            object.__setattr__(graph, "_sharded_csr", cache)
        if key not in cache:
            if graph.host_coo is not None:
                src, dst, w = graph.host_coo
            else:
                src, dst, w = graph.host_edges()
            if doubled:
                src, dst = (np.concatenate([src, dst]),
                            np.concatenate([dst, src]))
                w = np.concatenate([w, w])
            scsr = shard_edges(src, dst, w, graph.n_nodes, ctx.n_shards,
                               by=by)
            cache[key] = scsr.to_device(ctx)
    return cache[key]
