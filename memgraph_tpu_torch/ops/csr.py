"""Graph snapshot in CSR + CSC form, built on the host and placed as torch
tensors on a device.

Port of memgraph_tpu/ops/csr.py (``DeviceGraph``, ``from_coo``).  Node ids
are dense; ``n_nodes``/``n_edges`` are padded up to powers of two, and the
padding edges are zero-weight self loops on a sink row (index
``n_nodes``), so segment reductions ignore them.  ``from_coo`` takes the
native counting-sort builder (native/csr_builder.cpp) first and the numpy
lexsort path where that builder is unavailable; both give the same arrays.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device

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
