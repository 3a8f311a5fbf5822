"""Vector similarity search in PyTorch: brute-force kNN, k-means and IVF.

Port of memgraph_tpu/ops/knn.py.  Search is a dense product (scores =
Q @ Xᵀ) and a top-k; the metrics are the reference's vector-index
options: cosine, l2sq (squared euclidean, as -‖q - x‖² without the
query's term) and dot.  With ``use_bf16`` the operands are rounded to
bfloat16 and multiplied with f32 accumulation (XLA's
``preferred_element_type=f32``): here the rounded operands are upcast
and multiplied in full f32, since a bfloat16 ``torch.matmul`` returns
bfloat16.  Every f32 product runs at full f32 (``exact_f32_matmuls``).

``top_k`` keeps ``lax.top_k``'s order: descending, ties to the lower
index, masked (-inf) rows included, NaN above every number.
``kmeans_steps`` is the Lloyd loop; its centroid sums are the
deterministic run sum (ops/segment_cuda.py ``csr_spmm_sum``, K1) over
the points grouped by cluster in index order, where the reference
multiplies a one-hot matrix.
``kmeans_fit`` draws its initial rows without replacement from a
``torch.Generator`` (the reference's ``jax.random.choice`` stream is its
own).  ``IvfIndex`` probes the nearest cells and searches their members
exactly, a host loop a query, as the reference does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import exact_f32_matmuls, resolve_device
from . import segment_cuda as SC


def _row_normalized(x):
    return x / torch.clamp(torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)),
                           min=1e-12)


def top_k(scores, k: int):
    """(values, indices) of the k largest entries of each row of
    ``scores`` (q, n), descending, ties to the lower index (``lax.top_k``'s
    order, NaN above every number): every entry above the k-th value,
    then the lowest-indexed entries equal to it, then a stable sort of
    those k by value."""
    q = scores.shape[0]
    if k == 0:
        return (scores.new_zeros(q, 0),
                torch.zeros(q, 0, dtype=torch.int64, device=scores.device))
    kth = torch.topk(scores, k, dim=1).values[:, k - 1:k]
    # a NaN compares False with everything: rank it by hand
    nan, kth_nan = torch.isnan(scores), torch.isnan(kth)
    above = (scores > kth) | (nan & ~kth_nan)
    tied = (scores == kth) | (nan & kth_nan)
    need = k - above.sum(dim=1, keepdim=True)
    take = above | (tied & (torch.cumsum(tied, dim=1, dtype=torch.int32)
                            <= need))
    idx = take.nonzero()[:, 1].view(q, k)
    vals = scores.gather(1, idx)
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices
    return vals.gather(1, order), idx.gather(1, order)


def knn(corpus, queries, k: int, metric: str = "cosine",
        use_bf16: bool = True, valid_count=None, valid_mask=None):
    """Top-k nearest rows of ``corpus`` (n, d) for each of ``queries``
    (q, d), both f32 on one device (the CPU runs only when they lie
    there).  Returns (scores (q, k), indices (q, k)); higher score =
    closer.  ``valid_count``: rows >= valid_count are padding and never
    returned.  ``valid_mask``: (n,) — rows where it is not > 0 are masked
    out (their score is -inf)."""
    exact_f32_matmuls()
    x, qv = corpus, queries
    if metric == "cosine":
        x = _row_normalized(x)
        qv = _row_normalized(qv)
    if use_bf16:
        scores = (qv.to(torch.bfloat16).float()
                  @ x.to(torch.bfloat16).float().T)
    else:
        scores = qv @ x.T
    if metric == "l2sq":
        # -||q - x||^2 = 2 q·x - ||x||^2 - ||q||^2 ; drop the per-query term
        xsq = torch.sum(corpus.float() ** 2, dim=1)
        scores = 2.0 * scores - xsq[None, :]
    neg_inf = torch.tensor(float("-inf"), device=scores.device)
    if valid_count is not None:
        col = torch.arange(corpus.shape[0], device=scores.device)
        scores = torch.where(col[None, :] < valid_count, scores, neg_inf)
    if valid_mask is not None:
        scores = torch.where(valid_mask[None, :] > 0, scores, neg_inf)
    return top_k(scores, k)


def _assign(points, psq, cent):
    """The nearest centroid of each point (the first on a tie)."""
    d = (psq - (2.0 * points) @ cent.T
         + torch.sum(cent ** 2, dim=1)[None, :])
    return torch.argmin(d, dim=1)


def _centroids(points, assign, cent):
    """The mean of each cluster's points (a cluster with none keeps its
    centroid): the points' sums by K1 over their runs by cluster, each in
    index order from 0.0."""
    n_clusters = cent.shape[0]
    order = torch.sort(assign, stable=True).indices
    counts = torch.bincount(assign, minlength=n_clusters)
    ptr = torch.zeros(n_clusters + 1, dtype=torch.int32,
                      device=points.device)
    ptr[1:] = torch.cumsum(counts, dim=0)
    sums = SC.csr_spmm_sum(points, ptr, order, mul="first",
                           longest=int(counts.max()))
    counts = counts.to(torch.float32)[:, None]
    return torch.where(counts > 0, sums / torch.clamp(counts, min=1.0),
                       cent)


def kmeans_steps(points, cent0, iters: int = 10):
    """``iters`` Lloyd steps from the centroids ``cent0`` (k, d) on the
    points' device.  Returns (centroids, the assignment to them)."""
    exact_f32_matmuls()
    psq = torch.sum(points ** 2, dim=1, keepdim=True)
    cent = cent0
    for _ in range(int(iters)):
        cent = _centroids(points, _assign(points, psq, cent), cent)
    return cent, _assign(points, psq, cent)


def kmeans_init(n: int, n_clusters: int, generator=None) -> torch.Tensor:
    """The initial rows of ``kmeans_fit``: n_clusters of range(n) drawn
    without replacement from ``generator`` (a CPU torch.Generator)."""
    return torch.randperm(n, generator=generator)[:n_clusters]


def kmeans_fit(points, n_clusters: int, iters: int = 10, generator=None):
    """k-means of ``points`` (n, d) f32 on their device: initial rows from
    ``kmeans_init``, then ``kmeans_steps``.  Returns (centroids,
    assignment)."""
    rows = kmeans_init(points.shape[0], n_clusters, generator)
    return kmeans_steps(points, points[rows.to(points.device)], iters)


class IvfIndex:
    """IVF-flat index: coarse k-means cells; a search probes the closest
    cells and scores their members exactly."""

    def __init__(self, points, n_clusters: int = 64, seed: int = 0,
                 device=None):
        dev = resolve_device(device, like=points if isinstance(
            points, torch.Tensor) else None)
        points = torch.as_tensor(points, dtype=torch.float32).to(dev)
        n_clusters = max(1, min(n_clusters, points.shape[0]))
        gen = torch.Generator().manual_seed(int(seed))
        centroids, assign = kmeans_fit(points, n_clusters, generator=gen)
        assign = assign.cpu().numpy()
        order = np.argsort(assign, kind="stable")
        cell_start = np.concatenate(
            [[0], np.cumsum(np.bincount(assign, minlength=n_clusters))])
        self._hold(points, centroids, order, cell_start)

    @classmethod
    def from_arrays(cls, points, centroids, order, cell_start, device=None):
        """A trained index from its arrays (no k-means)."""
        index = cls.__new__(cls)
        dev = resolve_device(device)
        index._hold(torch.as_tensor(points, dtype=torch.float32).to(dev),
                    centroids, order, cell_start)
        return index

    def _hold(self, points, centroids, order, cell_start):
        dev = points.device
        self.points = points
        self.centroids = torch.as_tensor(centroids,
                                         dtype=torch.float32).to(dev)
        self.order = np.asarray(order, dtype=np.int64)
        self.sorted_points = points[torch.from_numpy(self.order).to(dev)]
        self.cell_start = np.asarray(cell_start, dtype=np.int64)
        self.n_clusters = len(self.cell_start) - 1

    def search(self, queries, k: int, n_probe: int = 8,
               metric: str = "cosine"):
        """Probe the n_probe nearest cells of each query; exact within
        them.  Returns host (scores (q, k) f32, ids (q, k) int64), padded
        with -inf / -1 where the probed cells hold fewer than k rows."""
        dev = self.points.device
        queries = torch.as_tensor(queries, dtype=torch.float32).to(dev)
        _, cell_idx = knn(self.centroids, queries,
                          k=min(n_probe, self.n_clusters), metric=metric,
                          use_bf16=False)
        cell_idx = cell_idx.cpu().numpy()
        start = self.cell_start
        out_scores, out_ids = [], []
        for qi in range(queries.shape[0]):
            member_rows = np.concatenate([
                np.arange(start[c], start[c + 1]) for c in cell_idx[qi]
            ]) if cell_idx.shape[1] else np.empty(0, np.int64)
            if len(member_rows) == 0:
                out_scores.append(np.full(k, -np.inf, np.float32))
                out_ids.append(np.full(k, -1, np.int64))
                continue
            cand = self.sorted_points[torch.from_numpy(member_rows).to(dev)]
            kk = min(k, len(member_rows))
            s, i = knn(cand, queries[qi:qi + 1], k=kk, metric=metric,
                       use_bf16=False)
            ids = self.order[member_rows[i[0].cpu().numpy()]]
            s = s[0].cpu().numpy()
            if kk < k:
                s = np.pad(s, (0, k - kk), constant_values=-np.inf)
                ids = np.pad(ids, (0, k - kk), constant_values=-1)
            out_scores.append(s)
            out_ids.append(ids)
        return np.stack(out_scores), np.stack(out_ids)


def ivf_from_jax(index, device=None) -> IvfIndex:
    """The port's IvfIndex of a trained reference index (its points,
    centroids, cell order and cell starts, any arrays numpy can read),
    on ``device`` (default: the card)."""
    return IvfIndex.from_arrays(
        np.array(index.points, dtype=np.float32),
        np.asarray(index.centroids, dtype=np.float32),
        np.asarray(index.order), np.asarray(index.cell_start), device)
