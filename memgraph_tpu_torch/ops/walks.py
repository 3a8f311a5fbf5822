"""Batched random walks in PyTorch (node2vec and friends).

Port of memgraph_tpu/ops/walks.py, with the reference's sampler: all B
walks advance one step at a time as tensors on the graph's device.  A
step draws three uniforms u1, u2, u3 from a ``torch.Generator``; the
candidate is the uniform neighbor ``col_idx[row_ptr[v] + min(int(u1 ·
deg), deg - 1)]`` (the product in f32), or v itself at a node with no
out-edge (the walk stalls there).  The second-order (p, q) bias is one
rejection test: α = 1/p when the candidate is the previous node, 1 when
the previous node has an edge to it, 1/q otherwise, accepted when u2 <=
α / max(1, 1/p, 1/q); a rejected candidate is replaced by a second
uniform neighbor (u3), without a further test.  At the first step the
previous node is the start.  The edge test is a binary search in the
previous node's CSR row (rows are sorted by dst: ops/csr.py exports the
CSR lexsorted by (src, dst)), with as many halvings as the longest row
needs (the reference runs 32; both end at the same bound).

No hand-written kernel runs here: each step is a few gathers and
elementwise operations on B values, exact in any order.
"""

from __future__ import annotations

import torch

from .csr import DeviceGraph
from .pagerank import graph_device, on_device


def _sample_neighbor(row_ptr, col_idx, v, u):
    """A uniform out-neighbor of each v (u ~ U[0, 1)), v itself where v
    has none."""
    start = row_ptr[v]
    deg = row_ptr[v + 1] - start
    off = torch.minimum((u * deg.to(torch.float32)).to(deg.dtype),
                        torch.clamp(deg - 1, min=0))
    at = torch.clamp(start + off, max=col_idx.numel() - 1)
    return torch.where(deg > 0, col_idx[at], v)


def _has_edge(row_ptr, col_idx, v, t, halvings: int):
    """Whether each v has an out-edge to t: a lower bound of t in v's
    sorted CSR row."""
    lo, end = row_ptr[v], row_ptr[v + 1]
    hi = end
    for _ in range(halvings):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        right = col_idx[torch.clamp(mid, max=col_idx.numel() - 1)] < t
        active = lo < hi
        lo, hi = (torch.where(active & right, mid + 1, lo),
                  torch.where(active & ~right, mid, hi))
    safe = torch.clamp(lo, max=col_idx.numel() - 1)
    return (lo < end) & (col_idx[safe] == t)


def random_walks(graph: DeviceGraph, starts, length: int, generator=None,
                 p: float = 1.0, q: float = 1.0, device=None):
    """(B, length + 1) int32 walks from the B dense node indices
    ``starts`` (the start first), on ``device`` (explicit, else the
    graph's, else the card).  ``generator``: a torch.Generator on that
    device (None: one seeded with 0).  p = q = 1 is DeepWalk's uniform
    walk (the test always accepts)."""
    dev = graph_device(graph, device)
    g = on_device(graph, dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    row_ptr, col_idx = g.row_ptr.long(), g.col_idx.long()
    cur = torch.as_tensor(starts, dtype=torch.int64).to(dev)
    prev = cur
    halvings = max(1, int(g.longest_csr_run or 0).bit_length())
    limit = max(1.0, 1.0 / p, 1.0 / q)
    alpha_back, alpha_far = 1.0 / p, 1.0 / q
    path = [cur]
    for _ in range(length):
        u1, u2, u3 = (torch.rand(cur.numel(), generator=generator,
                                 device=dev) for _ in range(3))
        cand = _sample_neighbor(row_ptr, col_idx, cur, u1)
        linked = _has_edge(row_ptr, col_idx, prev, cand, halvings)
        alpha = torch.where(cand == prev, alpha_back,
                            torch.where(linked, 1.0, alpha_far))
        accept = u2 <= (alpha / limit).to(torch.float32)
        nxt = torch.where(accept, cand,
                          _sample_neighbor(row_ptr, col_idx, cur, u3))
        prev, cur = cur, nxt
        path.append(cur)
    return torch.stack(path, dim=1).to(torch.int32)


def walks_to_skipgram_pairs(walks, window: int = 5):
    """The (center, context) pairs of walks (B, L) within ``window``, in
    the reference's order: for each walk, for each offset 1..window, its
    left pairs then its right pairs, each followed by ``offset`` pairs of
    -1; (2 · window · B · L, 2) for window <= L."""
    B, L = walks.shape
    pairs = []
    for off in range(1, window + 1):
        pad = walks.new_full((B, off, 2), -1)
        head = walks[:, :max(L - off, 0)]
        left = torch.stack([walks[:, off:], head], dim=-1)
        right = torch.stack([head, walks[:, off:]], dim=-1)
        pairs.append(torch.cat([left, pad], dim=1))
        pairs.append(torch.cat([right, pad], dim=1))
    return torch.cat(pairs, dim=1).reshape(-1, 2)
