"""Whole-graph traversal on the semiring core, in PyTorch: SSSP, BFS
levels, multi-source distances and k-hop neighbourhoods.

Port of memgraph_tpu/ops/traversal.py.  Shortest paths are a min-plus
fixpoint (Bellman-Ford: gather, ⊗ = plus, ⊕ = min until nothing
changes); the undirected step relaxes the reversed edges over the
distances just updated (Gauss-Seidel, about half the rounds).  BFS rides
direction-optimizing push/pull (``semiring.select_pull``, decided on the
host once a level): a sparse frontier relaxes only its own out-edges
(push), a dense one pulls over every edge; both give the same levels.

min is exact, so every reduction here is ``scatter_reduce_`` in any
order.  Padding edges get weight ``INF`` so they never relax anything.
Every entry point runs on the card unless the caller asks for the CPU
(``device="cpu"`` or a graph placed there); without a card it raises.
"""

from __future__ import annotations

import numpy as np
import torch

from . import semiring as S
from .csr import DeviceGraph
from .pagerank import graph_device, on_device

#: the "unreached" distance, as the reference's jnp.float32(3.4e38)
INF = float(np.float32(3.4e38))


def _inert_padding(g: DeviceGraph, w):
    """w with the padding edges' weights set to INF."""
    real = torch.arange(g.e_pad, device=w.device) < g.n_edges
    return torch.where(real, w, torch.full_like(w, INF))


def _unreached_to_inf(dist):
    return torch.where(dist >= INF / 2, torch.full_like(dist, np.inf), dist)


def _sssp_step_directed(dist, A, env, P, n_out):
    """min-plus relaxation: cand[v] = min over edges (u,v) of d[u] + w."""
    cand = S.spmv("min_plus", dist, A["src"], A["dst"], A["w"], n_out=n_out)
    return torch.minimum(dist, cand)


def _sssp_step_undirected(dist, A, env, P, n_out):
    """The directed pass, then the reverse orientation over the UPDATED
    distances (Gauss-Seidel: about half the rounds)."""
    new = _sssp_step_directed(dist, A, env, P, n_out)
    cand_b = S.spmv("min_plus", new, A["dst"], A["src"], A["w"],
                    n_out=n_out)
    return torch.minimum(new, cand_b)


def _sssp_epilogue(dist, new, env, P):
    return new, torch.any(new < dist)


def _start(g: DeviceGraph, source: int, dev):
    dist0 = torch.full((g.n_pad,), INF, dtype=torch.float32, device=dev)
    dist0[int(source)] = 0.0
    return dist0


def sssp(graph: DeviceGraph, source: int, weighted: bool = True,
         directed: bool = True, max_iterations: int = 10_000, device=None):
    """Bellman-Ford SSSP as a min-plus fixpoint.  Returns (dist[:n_nodes]
    float32 as a tensor on the device, +inf where unreachable,
    iterations).  weighted=False gives hop counts (BFS levels).
    ``device``: explicit, else the graph's, else the card."""
    dev = graph_device(graph, device)
    g = on_device(graph, dev)
    w = g.weights if weighted else torch.ones_like(g.weights)
    dist, _, iters = S.fixpoint(
        "min_plus",
        arrays={"src": g.src_idx.long(), "dst": g.col_idx.long(),
                "w": _inert_padding(g, w)},
        x0=_start(g, source, dev), n_out=g.n_pad,
        step=(_sssp_step_directed if directed
              else _sssp_step_undirected),
        epilogue=_sssp_epilogue, max_iterations=max_iterations,
        metric="changed")
    return _unreached_to_inf(dist[:g.n_nodes]), int(iters)


def _bfs_step(x, A, env, P, n_out):
    """Direction-optimizing BFS relaxation: push (frontier-masked
    contributions) while the frontier's out-edge mass is under n_edges /
    alpha, pull (every edge) once it is over.  The choice is read on the
    host and counted in ``do_bfs.levels``."""
    dist, frontier = x
    pull = bool(S.select_pull(frontier, A["deg"], P["n_edges"]))
    do_bfs.levels["pull" if pull else "push"] += 1
    new = S.spmv("min_plus", dist, A["src"], A["dst"], A["w"], n_out=n_out,
                 frontier=None if pull else frontier)
    return torch.minimum(dist, new)


def _bfs_epilogue(x, new, env, P):
    dist, _frontier = x
    new_frontier = new < dist
    return (new, new_frontier), torch.any(new_frontier)


def do_bfs(graph: DeviceGraph, source: int, max_iterations: int = 10_000,
           device=None):
    """Direction-optimizing BFS (directed): returns (dist f32 hops as a
    tensor on the device, +inf for unreachable, iterations).  Level-exact
    against the plain min-plus fixpoint: only the push/pull execution
    differs.  ``do_bfs.levels`` counts the push and pull levels run in
    this process."""
    dev = graph_device(graph, device)
    g = on_device(graph, dev)
    frontier0 = torch.zeros(g.n_pad, dtype=torch.bool, device=dev)
    frontier0[int(source)] = True
    (dist, _), _, iters = S.fixpoint(
        "min_plus",
        arrays={"src": g.src_idx.long(), "dst": g.col_idx.long(),
                "w": _inert_padding(g, torch.ones_like(g.weights)),
                "deg": g.out_degree},
        params={"n_edges": np.float32(g.n_edges)},
        x0=(_start(g, source, dev), frontier0), n_out=g.n_pad,
        step=_bfs_step, epilogue=_bfs_epilogue,
        max_iterations=max_iterations, metric="changed")
    return _unreached_to_inf(dist[:g.n_nodes]), int(iters)


do_bfs.levels = {"push": 0, "pull": 0}


def bfs_levels(graph: DeviceGraph, source: int, directed: bool = True,
               max_iterations: int = 10_000, device=None):
    """BFS levels from ``source`` (-1 for unreachable) as an int32 tensor
    on the device, and the iterations.  The directed case rides the
    push/pull path; the undirected view the Gauss-Seidel min-plus
    fixpoint."""
    if directed:
        dist, iters = do_bfs(graph, source, max_iterations=max_iterations,
                             device=device)
    else:
        dist, iters = sssp(graph, source, weighted=False, directed=False,
                           max_iterations=max_iterations, device=device)
    levels = torch.where(torch.isinf(dist), torch.full_like(dist, -1),
                         dist).to(torch.int32)
    return levels, iters


def multi_source_sssp(graph: DeviceGraph, sources, weighted: bool = True,
                      directed: bool = True, max_iterations: int = 10_000,
                      device=None):
    """Distances from each of B sources, as a (B, n_nodes) float32 tensor
    on the device (+inf where unreachable).  The B sources run as the
    lanes of one (n_pad, B) min-plus fixpoint; the loop stops once no
    lane changes or after ``max_iterations`` rounds.  A converged lane
    stays as it is in later rounds (min is idempotent), as each lane of
    the reference's vmapped loop stops on its own."""
    dev = graph_device(graph, device)
    g = on_device(graph, dev)
    w = _inert_padding(g, g.weights if weighted
                       else torch.ones_like(g.weights))
    src, dst = g.src_idx.long(), g.col_idx.long()
    if not directed:
        src, dst = torch.cat([src, dst]), torch.cat([dst, src])
        w = torch.cat([w, w])
    sources = torch.as_tensor(np.asarray(sources, dtype=np.int64),
                              device=dev)
    lanes = sources.numel()
    dist = torch.full((g.n_pad, lanes), INF, dtype=torch.float32,
                      device=dev)
    dist[sources, torch.arange(lanes, device=dev)] = 0.0
    changed, it = lanes > 0, 0
    while changed and it < max_iterations:
        cand = S.spmv("min_plus", dist, src, dst, w, n_out=g.n_pad)
        new = torch.minimum(dist, cand)
        changed = bool(torch.any(new < dist))
        dist, it = new, it + 1
    return _unreached_to_inf(dist[:g.n_nodes].T.contiguous())


def khop_neighborhood(graph: DeviceGraph, sources, k: int,
                      directed: bool = False, device=None):
    """Boolean mask (n_nodes,) on the device of the nodes within k hops of
    any source.  Each Bellman-Ford round extends reach by at least one
    hop, so k rounds settle every node within k hops."""
    levels = multi_source_sssp(graph, sources, weighted=False,
                               directed=directed, max_iterations=k + 1,
                               device=device)
    return torch.any(levels <= float(k), dim=0)
