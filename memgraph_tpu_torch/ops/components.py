"""Connected components on the semiring core, in PyTorch.

Port of memgraph_tpu/ops/components.py.  WCC is a min-first semiring
fixpoint over both edge directions (the graph taken as undirected) with
pointer jumping (path halving) fused into the epilogue, which converges
in O(log n) rounds instead of O(diameter).  SCC is multi-pivot
forward-backward coloring whose propagation rounds are masked min-first
matvecs (edges with a settled endpoint contribute ``mask_fill``), driven
by a host loop with trimming and a no-progress guard.

min is exact, so these reduce with ``scatter_reduce_`` in any order; the
trim's in- and out-degrees are integer sums (``index_add_``, exact).
Every entry point runs on the card unless the caller asks for the CPU
(``device="cpu"`` or a graph placed there); without a card it raises.
"""

from __future__ import annotations

import numpy as np
import torch

from . import semiring as S
from .csr import DeviceGraph
from .pagerank import graph_device, on_device


def _wcc_epilogue(comp, acc, env, P):
    """Fused WCC epilogue: keep the smaller label, then pointer-jump
    (path halving: comp[v] = comp[comp[v]]) and the changed partial."""
    new_comp = torch.minimum(comp, acc)
    new_comp = new_comp[new_comp]
    return new_comp, torch.any(new_comp != comp)


def weakly_connected_components(graph: DeviceGraph,
                                max_iterations: int = 200, comp0=None,
                                device=None, mesh=None):
    """Returns (component_id[:n_nodes] as a host int32 array, iterations).
    Component ids are the minimum dense node index in each component.

    ``comp0`` warm-starts the min-label propagation from a previous
    assignment; it is only valid when the graph since that assignment
    ADDED edges (min labels can merge components, never split them).
    ``device``: explicit, else the graph's, else the card.  ``mesh``
    routes through the mesh (parallel/analytics.py ``components_mesh``;
    see ops.pagerank.pagerank)."""
    dev = graph_device(graph, device)
    backend, ctx = S.route_backend(graph, dev, mesh, semiring="min_first")
    if backend == "mesh":
        from ..parallel.analytics import components_mesh
        return components_mesh(graph, ctx, max_iterations=max_iterations,
                               comp0=comp0)
    g = on_device(graph, dev)
    start = np.arange(g.n_pad, dtype=np.int32)
    if comp0 is not None:
        arr = np.asarray(comp0, dtype=np.int32)[:g.n_nodes]
        start[:len(arr)] = arr
    comp, _, iters = S.fixpoint(
        "min_first", arrays={"src": g.src_idx.long(),
                             "dst": g.col_idx.long()},
        x0=torch.from_numpy(start).to(dev), n_out=g.n_pad,
        epilogue=_wcc_epilogue, max_iterations=max_iterations,
        metric="changed", direction="both")
    return comp[:g.n_nodes].cpu().numpy(), int(iters)


def _propagate(lab0, a, b, edge_ok, big: int, n_pad: int,
               max_iterations: int):
    """Min-label propagation along the edges a -> b where ``edge_ok``,
    to its fixpoint (or ``max_iterations`` rounds), read on the host once
    a round."""
    lab, changed, it = lab0, True, 0
    while changed and it < max_iterations:
        cand = S.spmv("min_first", lab, a, b, n_out=n_pad, mask=edge_ok,
                      mask_fill=big)
        new = torch.minimum(lab, cand)
        changed = bool(torch.any(new != lab))
        lab, it = new, it + 1
    return lab


def _scc_round(src, dst, comp, n_pad: int, max_iterations: int):
    """One multi-pivot forward-backward coloring round over the unsettled
    subgraph (comp < 0 means unsettled).

    With labels = own index on unsettled nodes, after min-label
    propagation fwd(v) = the min index that reaches v and bwd(v) = the
    min index v reaches (within the unsettled subgraph).  fwd(v) ==
    bwd(v) == m means m reaches v and v reaches m, so v is in m's SCC;
    every set settled this round is one whole SCC, and at least the SCC of
    the minimum unsettled index settles.
    """
    ids = torch.arange(n_pad, dtype=torch.int32, device=comp.device)
    unsettled = comp < 0
    big = n_pad
    lab0 = torch.where(unsettled, ids, torch.full_like(ids, big))
    # propagation only along edges with both endpoints unsettled: the
    # masked min-first matvec (masked edges contribute the sentinel)
    edge_ok = unsettled[src] & unsettled[dst]
    fwd = _propagate(lab0, src, dst, edge_ok, big, n_pad, max_iterations)
    bwd = _propagate(lab0, dst, src, edge_ok, big, n_pad, max_iterations)
    settle = unsettled & (fwd == bwd) & (fwd < big)
    return torch.where(settle, fwd, comp)


def _scc_trim(src, dst, comp, n_pad: int, max_iterations: int):
    """Trim to fixpoint: unsettled nodes with no unsettled in-neighbours
    or no unsettled out-neighbours are singleton SCCs.  The degrees are
    integer sums."""
    ids = torch.arange(n_pad, dtype=torch.int32, device=comp.device)
    changed, it = True, 0
    while changed and it < max_iterations:
        unsettled = comp < 0
        edge_ok = (unsettled[src] & unsettled[dst]).to(torch.int32)
        in_deg = S.edge_reduce("sum", edge_ok, dst, n_pad)
        out_deg = S.edge_reduce("sum", edge_ok, src, n_pad)
        trim = unsettled & ((in_deg == 0) | (out_deg == 0))
        comp = torch.where(trim, ids, comp)
        changed = bool(torch.any(trim))
        it += 1
    return comp


def strongly_connected_components(graph: DeviceGraph,
                                  max_iterations: int = 1 << 30,
                                  device=None, stats: dict | None = None):
    """SCC labels as a host int32 array (equal label ⇔ same SCC; label =
    the min dense index in the SCC).

    Multi-pivot FW-BW coloring with trimming; the outer loop runs on the
    host.  At least one SCC settles a round.  ``max_iterations`` bounds
    the inner propagation loops; the default is effectively unbounded,
    because correctness needs each propagation run to its fixpoint (a
    C-node cycle needs C rounds).  ``stats`` (port only), when given, is
    filled with the number of coloring ``rounds``.  ``device``: explicit,
    else the graph's, else the card."""
    dev = graph_device(graph, device)
    g = on_device(graph, dev)
    n_pad = g.n_pad
    src, dst = g.src_idx.long(), g.col_idx.long()
    ids = torch.arange(n_pad, dtype=torch.int32, device=dev)
    comp = torch.where(ids < g.n_nodes, torch.full_like(ids, -1), ids)
    rounds = 0
    while True:
        comp = _scc_trim(src, dst, comp, n_pad, max_iterations)
        if not bool(torch.any(comp < 0)):
            break
        before = comp
        comp = _scc_round(src, dst, comp, n_pad, max_iterations)
        rounds += 1
        if not bool(torch.any(comp < 0)):
            break
        if bool(torch.all(comp == before)):  # safety: no progress → stop
            comp = torch.where(comp < 0, ids, comp)
            break
    if stats is not None:
        stats["rounds"] = rounds
    return comp[:g.n_nodes].cpu().numpy()
