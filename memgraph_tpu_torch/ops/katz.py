"""Katz centrality, HITS and degree centrality on the semiring core, in
PyTorch.

Port of memgraph_tpu/ops/katz.py.  Katz is the fixpoint x ← α·Aᵀx + β
as a plus-times semiring fixpoint with the update and the L∞
convergence partial fused into the loop body; it converges for α <
1/λ_max(A).  Large graphs on the card take the gather-free MXU backend
(``semiring.mxu_fixpoint`` with ``normalize=False``): on a graph whose
PageRank plan exists (or that katz plans first) katz rides that plan's
placed routes and places only its own multipliers.  HITS runs two
matvecs a round on the segment backend (a ``step`` hook); degree
centrality is one integer segment sum over the edges a direction.  The
segment backend's float sums are the deterministic run sums of
ops/segment_cuda.py, over the graph's CSC and CSR runs.

Every entry point runs on the card unless the caller asks for the CPU
(``device="cpu"`` or a graph placed there); without a card it raises.
"""

from __future__ import annotations

import numpy as np
import torch

from . import semiring as S
from .csr import DeviceGraph
from .pagerank import f32_scalar, graph_device, on_device


def _valid(P, n_out, dev):
    return (torch.arange(n_out, device=dev) < P["n_nodes"]).to(torch.float32)


def _katz_setup(A, P, n_out):
    valid_f = _valid(P, n_out, A["src"].device)
    return {"valid_f": valid_f, "x0": torch.zeros_like(valid_f)}


def _katz_epilogue(x, acc, env, P):
    """Fused katz update: new = valid * (alpha * Aᵀx + beta), with the
    L∞ convergence partial in the same body."""
    new_x = env["valid_f"] * (P["alpha"] * acc + P["beta"])
    return new_x, torch.max(torch.abs(new_x - x))


def _katz_mxu_epilogue(x, acc, env, P):
    """The same update on the MXU backend's out-labeled accumulator."""
    new_x = env["valid"] * (P["alpha"] * acc + P["beta"])
    return new_x, torch.max(torch.abs(new_x - x))


def _katz_normalized(x, normalized: bool):
    if not normalized:
        return x
    return x / torch.clamp(torch.sqrt(torch.sum(x * x)), min=1e-30)


def katz_centrality(graph: DeviceGraph, alpha: float = 0.2,
                    beta: float = 1.0, max_iterations: int = 100,
                    tol: float = 1e-6, normalized: bool = False,
                    precision: str = "f32", x0=None, device=None,
                    mesh=None):
    """Returns (centralities[:n_nodes] as a tensor on the device, error,
    iterations).

    ``precision`` selects the f32 / bf16 / int8 variants (int8 on the
    segment backend only; see ops.pagerank.pagerank).  ``x0`` warm-starts
    from a previous solution (a contraction for α < 1/λ_max: the same
    fixpoint at the same tol from any seed).  ``normalized`` divides by
    the L2 norm.  ``device``: explicit, else the graph's, else the
    card.  ``mesh`` routes through the mesh (parallel/analytics.py
    ``katz_mesh``; see ops.pagerank.pagerank)."""
    S._check_precision(precision)
    dev = graph_device(graph, device)
    backend, ctx = S.route_backend(graph, dev, mesh, precision=precision)
    if backend == "mesh":
        from ..parallel.analytics import katz_mesh
        return katz_mesh(graph, ctx, alpha=alpha, beta=beta,
                         max_iterations=max_iterations, tol=tol,
                         normalized=normalized, precision=precision, x0=x0)
    if backend == "mxu":
        x, err, iters = S.mxu_fixpoint(
            graph, epilogue=_katz_mxu_epilogue,
            params={"alpha": np.float32(alpha), "beta": np.float32(beta)},
            max_iterations=max_iterations, tol=tol, normalize=False,
            precision=precision, cache_tag="katz", x0_default="zeros",
            x0=x0, device=dev)
        return _katz_normalized(x, normalized)[:graph.n_nodes], err, iters
    g = on_device(graph, dev)
    x0_pad = None
    if x0 is not None:
        buf = np.zeros(g.n_pad, dtype=np.float32)
        arr = np.asarray(x0, dtype=np.float32)[:g.n_nodes]
        buf[:len(arr)] = arr
        x0_pad = torch.from_numpy(buf).to(dev)
    x, err, iters = S.fixpoint(
        "plus_times",
        arrays={"src": g.csc_src, "dst": g.csc_dst, "w": g.csc_weights,
                "dst_ptr": g.csc_runs(), "dst_longest": g.longest_csc_run},
        params={"n_nodes": g.n_nodes, "alpha": f32_scalar(alpha, dev),
                "beta": f32_scalar(beta, dev), "tol": np.float32(tol)},
        n_out=g.n_pad, setup=_katz_setup, epilogue=_katz_epilogue,
        max_iterations=max_iterations, sorted=True, precision=precision,
        x0=x0_pad)
    return _katz_normalized(x, normalized)[:g.n_nodes], err, iters


def _l2_normalized(v):
    return v / torch.clamp(torch.sqrt(torch.sum(v * v)), min=1e-30)


def _hits_step(x, A, env, P, n_out):
    """One HITS round: two plus-times matvecs (authority from the hubs
    over the CSC edges, then hubs from the new authorities over the CSR
    edges reversed), each L2-normalized, over a (hub, auth) state.  Both
    sums are over sorted keys: CSC destinations (``csc_runs``), then CSR
    sources (``row_ptr``'s runs)."""
    hub, _auth = x
    valid_f = env["valid_f"]
    new_auth = _l2_normalized(S.spmv(
        "plus_times", hub, A["csrc"], A["cdst"], A["cw"], n_out=n_out,
        sorted=True, ptr=A["cptr"], longest=A["clongest"]) * valid_f)
    new_hub = _l2_normalized(S.spmv(
        "plus_times", new_auth, A["dst"], A["src"], A["w"], n_out=n_out,
        sorted=True, ptr=A["rptr"], longest=A["rlongest"]) * valid_f)
    return new_hub, new_auth


def _hits_setup(A, P, n_out):
    valid_f = _valid(P, n_out, A["src"].device)
    return {"valid_f": valid_f, "x0": (valid_f, valid_f)}


def _hits_epilogue(x, acc, env, P):
    hub, auth = x
    new_hub, new_auth = acc
    err = (torch.max(torch.abs(new_auth - auth))
           + torch.max(torch.abs(new_hub - hub)))
    return (new_hub, new_auth), err


def hits(graph: DeviceGraph, max_iterations: int = 100, tol: float = 1e-6,
         device=None):
    """Returns (hubs[:n_nodes], authorities[:n_nodes], error, iterations),
    the vectors as tensors on the device; error is max|Δauth| +
    max|Δhub| of the last round."""
    dev = graph_device(graph, device)
    g = on_device(graph, dev)
    (hub, auth), err, iters = S.fixpoint(
        "plus_times",
        arrays={"src": g.src_idx, "dst": g.col_idx, "w": g.weights,
                "rptr": g.row_ptr, "rlongest": g.longest_csr_run,
                "csrc": g.csc_src, "cdst": g.csc_dst, "cw": g.csc_weights,
                "cptr": g.csc_runs(), "clongest": g.longest_csc_run},
        params={"n_nodes": g.n_nodes, "tol": np.float32(tol)},
        n_out=g.n_pad, setup=_hits_setup, step=_hits_step,
        epilogue=_hits_epilogue, max_iterations=max_iterations)
    return hub[:g.n_nodes], auth[:g.n_nodes], err, iters


def degree_centrality(graph: DeviceGraph, direction: str = "total",
                      device=None):
    """In-, out- or total degree over max(n - 1, 1), as a tensor on the
    device (padding edges masked out).  The counts are integer sums
    (``index_add_``, exact in any order), the same values as the
    reference's float32 sums of 0/1 (exact below 2^24)."""
    dev = graph_device(graph, device)
    g = on_device(graph, dev)
    mask = (torch.arange(g.e_pad, device=dev) < g.n_edges).to(torch.int32)
    if direction == "in":
        d = S.edge_reduce("sum", mask, g.col_idx, g.n_pad)
    elif direction == "out":
        d = S.edge_reduce("sum", mask, g.src_idx, g.n_pad)
    else:
        d = (S.edge_reduce("sum", mask, g.col_idx, g.n_pad)
             + S.edge_reduce("sum", mask, g.src_idx, g.n_pad))
    d = d.to(torch.float32)
    # a tensor divisor: CUDA divides by a host scalar as a product with
    # its reciprocal, which is not the division's rounding
    return (d / torch.full_like(d, max(g.n_nodes - 1, 1)))[:g.n_nodes]
