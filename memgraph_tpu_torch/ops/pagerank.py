"""PageRank on the plus-times semiring core (ops/semiring.py), in PyTorch.

Port of memgraph_tpu/ops/pagerank.py (``pagerank`` and its MXU and segment
backends).  Weighted power iteration: the setup hoists the per-edge
``w / wsum[src]`` multipliers, the fused epilogue applies the damping
update (semiring.pagerank_update) and the L1 convergence partial.
Dangling-node mass is redistributed uniformly each round.  Padding edges
carry weight 0 into a sink row, so they contribute nothing.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..device import resolve_device
from . import semiring as S
from .csr import DeviceGraph

# read at call time: tests and operators tune the threshold by
# monkeypatching this module attribute
MXU_MIN_EDGES = S.MXU_MIN_EDGES

# the route dtype each precision asks for; None: MEMGRAPH_TPU_ROUTE_DTYPE
# decides (spmv_mxu.resolve_route_dtype), as on the reference's f32 path
_ROUTE_DTYPES = {"f32": None, "bf16": torch.bfloat16}

# serializes the plan build (about 30 s host-side at 10M edges) and the
# kernel placements PER GRAPH, so that concurrent first calls on one
# snapshot build once while unrelated graphs build in parallel; the guard
# only serializes the creation of each graph's lock
_mxu_locks_guard = threading.Lock()


def _pagerank_setup(A, P, n_out):
    """Loop invariants: hoisted edge multipliers + dangling/valid masks."""
    n_nodes = P["n_nodes"]
    dev = A["src"].device
    n_f = torch.tensor(float(n_nodes), dtype=torch.float32, device=dev)
    valid = torch.arange(n_out, device=dev) < n_nodes
    valid_f = valid.to(torch.float32)
    wsum = S.edge_reduce("sum", A["csr_w"], A["csr_src"], n_out)
    inv_wsum = torch.where(wsum > 0, 1.0 / torch.clamp(wsum, min=1e-30),
                           torch.zeros_like(wsum))
    dangling_f = (valid & (wsum <= 0)).to(torch.float32)
    edge_mult = A["w"] * inv_wsum[A["src"]]  # hoisted: one gather per run
    return {"w": edge_mult, "valid_f": valid_f, "dangling_f": dangling_f,
            "n_f": n_f, "x0": valid_f / n_f}


def _pagerank_epilogue(rank, acc, env, P):
    """Fused epilogue: damping update + L1 convergence partial."""
    dangling_mass = torch.sum(rank * env["dangling_f"])
    new_rank = S.pagerank_update(acc, dangling_mass, env["valid_f"],
                                 env["n_f"], P["damping"])
    err = torch.sum(torch.abs(new_rank - rank))
    return new_rank, err


def _build_lock(graph: DeviceGraph) -> threading.Lock:
    """The graph's own lock for its plan build and kernel placements."""
    with _mxu_locks_guard:
        lock = getattr(graph, "_mxu_build_lock", None)
        if lock is None:
            lock = threading.Lock()
            # DeviceGraph is frozen; bypass its setattr guard
            object.__setattr__(graph, "_mxu_build_lock", lock)
    return lock


def _mxu_state(graph: DeviceGraph) -> dict:
    """The graph's MXU plan and its kernels, built once per snapshot and
    cached on it ({"plan", "plan_build_s", "runs": {(device, route dtype):
    run}})."""
    state = getattr(graph, "_mxu_state", None)
    if state is not None:
        return state
    from . import spmv_mxu
    with _build_lock(graph):
        state = getattr(graph, "_mxu_state", None)
        if state is None:
            t0 = time.perf_counter()
            src, dst, w = graph.host_edges()
            plan = spmv_mxu.build_plan(src, dst, w, graph.n_nodes)
            state = {"plan": plan,
                     "plan_build_s": time.perf_counter() - t0, "runs": {}}
            # DeviceGraph is frozen; bypass its setattr guard
            object.__setattr__(graph, "_mxu_state", state)
    return state


def _pagerank_via_mxu(graph: DeviceGraph, device: torch.device, damping,
                      max_iterations, tol, precision: str = "f32", x0=None):
    """Large-graph path: the gather-free MXU kernel, one plan per graph
    snapshot serving every precision (the route dtype only changes the
    contributions' width).

    The placed kernel is cached per (device, route dtype), the dtype
    resolved at each call: f32 takes MEMGRAPH_TPU_ROUTE_DTYPE's, so
    under ``bf16`` it routes bf16 and shares the bf16 run.  The reference
    caches its f32 kernel once per graph, with the variable as it was at
    the first call; here a later change of the variable takes effect on
    the next call (another run is placed), and no run is returned under a
    dtype it was not built for."""
    from . import spmv_mxu
    state = _mxu_state(graph)
    plan = state["plan"]
    route_dtype = spmv_mxu.resolve_route_dtype(_ROUTE_DTYPES[precision])
    key = (str(device), route_dtype)
    run = state["runs"].get(key)
    if run is None:
        with _build_lock(graph):
            run = state["runs"].get(key)
            if run is None:
                run = spmv_mxu.make_pagerank_kernel(
                    plan, route_dtype=route_dtype, device=device)
                run.out_relabel = torch.from_numpy(
                    plan.out_relabel).to(device)
                state["runs"][key] = run
    x0_flat = None
    if x0 is not None:
        # warm seed in the plan's OUT labeling (flat node space); the
        # kernel renormalizes nothing — pass unit mass in
        x0 = np.asarray(x0, dtype=np.float32)[:graph.n_nodes]
        total = float(x0.sum())
        if np.isfinite(total) and total > 0.0:
            x0_flat = np.zeros(len(plan.valid_out), dtype=np.float32)
            x0_flat[plan.out_relabel] = x0 / np.float32(total)
    rank, err, iters = run(x0_flat, damping, int(max_iterations), tol)
    return rank[run.out_relabel], err, iters


def pagerank(graph: DeviceGraph, damping: float = 0.85,
             max_iterations: int = 100, tol: float = 1e-6,
             precision: str = "f32", x0=None, device=None):
    """Returns (ranks[:n_nodes] as a tensor on the device, error,
    iterations).

    ``device`` — where to run: explicit, else the graph's device (after
    ``graph.to_device``), else the card.  Without a card and without an
    explicit CPU request this raises.

    ``precision`` — "f32" (exact), "bf16" (contributions rounded, f32
    accumulation) or "int8" (quantized streaming; segment backend only);
    error bounds: semiring.PRECISION_BOUNDS.

    ``x0`` — optional (n_nodes,) previous solution; warm-starts the
    fixpoint (PageRank is a contraction, any seed converges to the same
    answer at the same tol — the seed only cuts the iteration count).
    """
    S._check_precision(precision)
    dev = resolve_device(device, like=None if graph.device is None
                         else graph.row_ptr)
    backend = S.route_backend(graph, dev, precision=precision,
                              min_edges=MXU_MIN_EDGES)
    if backend == "mxu":
        return _pagerank_via_mxu(graph, dev, damping, max_iterations, tol,
                                 precision, x0=x0)
    g = graph if graph.device == dev else graph.to_device(dev)
    x0_pad = None
    if x0 is not None:
        x0 = np.asarray(x0, dtype=np.float32)[:g.n_nodes]
        total = float(x0.sum())
        if np.isfinite(total) and total > 0.0:
            buf = np.zeros(g.n_pad, dtype=np.float32)
            buf[:len(x0)] = x0 / np.float32(total)
            x0_pad = torch.from_numpy(buf).to(dev)
    rank, err, iters = S.fixpoint(
        arrays={"src": g.csc_src.long(), "dst": g.csc_dst.long(),
                "w": g.csc_weights,
                "csr_src": g.src_idx.long(), "csr_w": g.weights},
        params={"n_nodes": g.n_nodes,
                "damping": torch.tensor(damping, dtype=torch.float32,
                                        device=dev),
                "tol": np.float32(tol)},
        n_out=g.n_pad, setup=_pagerank_setup,
        epilogue=_pagerank_epilogue, max_iterations=max_iterations,
        precision=precision, x0=x0_pad)
    return rank[:g.n_nodes], err, iters
