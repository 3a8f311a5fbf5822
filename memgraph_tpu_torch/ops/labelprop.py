"""Community detection by synchronous label propagation on the semiring
core, in PyTorch.

Port of memgraph_tpu/ops/labelprop.py.  Each round every node adopts the
label carrying the largest total incident edge weight among its
neighbors (both directions unless ``directed``), the least such label on
a tie, and keeps its own label when that weighs at least as much
(``self_weight``) or it has no neighbor.  The election of a round:

  1. the neighbor labels gathered onto the edges: lab_e = label[src_e]
  2. one stable sort of the (dst_e, lab_e) pairs, as an int64 key
  3. the weight of each run of equal pairs, summed by the deterministic
     run sum (ops/segment_cuda.py ``csr_spmm_sum`` in its no-gather form:
     each run adds in edge order from 0.0)
  4. max-weight, then min-label ``scatter_reduce_`` passes over the
     runs elect each node's label

and the round's epilogue is the own-label-wins rule and whether any
label changed (``semiring.fixpoint``'s "changed" metric, read on the
host once a round).
"""

from __future__ import annotations

import numpy as np
import torch

from . import semiring as S
from .csr import DeviceGraph
from .pagerank import graph_device, on_device


def _labelprop_step(labels, A, env, P, n_out):
    """One election round; returns the proposed labels (the ``acc``).

    The reference scatters over all e2 run slots, the ids past the last
    run clamped onto the last sorted edge's dst with weight 0.0 and no
    candidate label.  Here the runs are counted (the host learns the
    count with the run starts) and only they are scattered; the empty
    slots' one effect, best_w[that dst] = max(best_w, 0.0), is applied
    to that dst alone, so the election is the reference's bit for bit
    (it matters only for negative weights on a graph with no padding
    edges)."""
    src2, dst2, w2 = A["src"], A["dst"], A["w"]
    e2 = src2.shape[0]
    lab_e = labels[src2]
    # lexicographic (dst, neighbor label) order by one stable sort; within
    # a run the edges keep their order, so each run sums in edge order
    order = torch.sort(dst2.long() * n_out + lab_e.long(), stable=True)[1]
    d_s, l_s, w_s = dst2[order], lab_e[order], w2[order]
    first = torch.ones(e2, dtype=torch.bool, device=labels.device)
    first[1:] = (d_s[1:] != d_s[:-1]) | (l_s[1:] != l_s[:-1])
    # run r is [starts[r], starts[r + 1]): the dense run ids; a run's
    # first element, the reference's min index of the run, is its start
    starts = torch.nonzero(first).view(-1)
    n_runs = starts.numel()
    # the runs' offsets; the sink's run of padding edges (every edge into
    # the sink is one, weight 0.0, sorted last) is left out as csc_runs()
    # leaves it out: its sum is 0.0 either way, and one thread would walk
    # it serially
    ptr = torch.full((n_runs + 1,), P["n_true"], dtype=torch.int32,
                     device=labels.device)
    ptr[:n_runs] = starts.clamp(max=P["n_true"])
    run_w = S.edge_reduce("sum", w_s, None, n_runs, sorted=True, ptr=ptr)
    run_dst = d_s[starts]
    run_lab = l_s[starts]
    best_w = S.edge_reduce("max", run_w, run_dst, n_out)
    if n_runs < e2:
        last = d_s[-1:].long()
        best_w[last] = torch.clamp(best_w[last], min=0.0)
    # the least label among the runs of a node's best weight
    is_best = run_w >= best_w[run_dst.long()] - 1e-12
    cand_lab = torch.where(is_best, run_lab, torch.full_like(run_lab, n_out))
    best_lab = S.edge_reduce("min", cand_lab, run_dst, n_out)
    has_nb = best_lab < n_out
    self_weight = P["self_weight"]
    # own label wins when it weighs at least as much, or with no neighbor
    own_wins = (~has_nb) | (self_weight >= best_w) | (
        torch.isclose(self_weight.expand_as(best_w), best_w, rtol=1e-5,
                      atol=1e-8) & (labels <= best_lab))
    return torch.where(own_wins, labels, best_lab)


def _labelprop_epilogue(labels, proposed, env, P):
    return proposed, torch.any(proposed != labels)


def label_propagation(graph: DeviceGraph, max_iterations: int = 30,
                      self_weight: float = 0.0, directed: bool = False,
                      labels0=None, device=None, mesh=None):
    """Returns (community label[:n_nodes] as a host int32 array,
    iterations).

    Labels are dense node indices (a community's label is one member's
    id).  The undirected view (``directed=False``) mirrors every edge,
    padding edges included, as the reference does.  ``labels0``
    warm-starts the election from a previous labeling (valid over
    adds-only deltas only, as the reference warns).  ``device``:
    explicit, else the graph's, else the card.  ``mesh`` routes through
    the mesh (parallel/analytics.py ``label_propagation_mesh``; see
    ops.pagerank.pagerank)."""
    dev = graph_device(graph, device)
    backend, ctx = S.route_backend(graph, dev, mesh, semiring="max_min")
    if backend == "mesh":
        from ..parallel.analytics import label_propagation_mesh
        with S.backend_extent("mesh"):
            return label_propagation_mesh(
                graph, ctx, max_iterations=max_iterations,
                self_weight=self_weight, directed=directed,
                labels0=labels0)
    g = on_device(graph, dev)
    if directed:
        src2, dst2, w2 = g.src_idx, g.col_idx, g.weights
        n_true = g.n_edges
    else:
        src2 = torch.cat([g.src_idx, g.col_idx])
        dst2 = torch.cat([g.col_idx, g.src_idx])
        w2 = torch.cat([g.weights, g.weights])
        n_true = 2 * g.n_edges
    start = np.arange(g.n_pad, dtype=np.int32)
    if labels0 is not None:
        arr = np.asarray(labels0, dtype=np.int32)[:g.n_nodes]
        start[:len(arr)] = arr
    labels, _, iters = S.fixpoint(
        "max_min", arrays={"src": src2.long(), "dst": dst2, "w": w2},
        params={"self_weight": torch.tensor(np.float32(self_weight),
                                            device=dev),
                "n_true": n_true},
        x0=torch.from_numpy(start).to(dev), n_out=g.n_pad,
        step=_labelprop_step, epilogue=_labelprop_epilogue,
        max_iterations=max_iterations, metric="changed")
    return labels[:g.n_nodes].cpu().numpy(), int(iters)
