"""PageRank and personalized PageRank on the plus-times semiring core
(ops/semiring.py), in PyTorch.

Port of memgraph_tpu/ops/pagerank.py: ``pagerank`` and its MXU and segment
backends, ``personalized_pagerank``, the batched multi-source
``personalized_pagerank_batch`` and ``ppr_topk``.  Weighted power
iteration: the setup hoists the per-edge ``w / wsum[src]`` multipliers,
the fused epilogue applies the damping update (semiring.pagerank_update)
and the L1 convergence partial.  Dangling-node mass is redistributed
uniformly each round (PPR: to the restart vector).  Padding edges carry
weight 0 into a sink row, so they contribute nothing.

Snapshot refresh: a snapshot whose ``_delta_ctx`` is ``(base graph,
changed gids)`` (set as the JAX package's ``GraphCache.get`` sets it, with
``object.__setattr__`` on the frozen graph) and whose base holds a full
MXU plan takes an O(changed-edges) ``spmv_mxu.DeltaPlan`` side-net
instead of a full replan; its runs share the base plan's placed routes.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..device import resolve_device
from . import segment_cuda as SC
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
    edge_mult, dangling_f = _hoisted(A, valid, n_out)
    return {"w": edge_mult, "valid_f": valid_f, "dangling_f": dangling_f,
            "n_f": n_f, "x0": valid_f / n_f}


def _hoisted(A, valid, n_out):
    """The per-edge ``w / wsum[src]`` multipliers (one gather per run) and
    the dangling mask, from the CSR weight sums (over ``row_ptr``'s
    runs)."""
    wsum = S.edge_reduce("sum", A["csr_w"], A["csr_src"], n_out,
                         sorted=True, ptr=A["csr_ptr"],
                         longest=A.get("csr_longest"))
    inv_wsum = torch.where(wsum > 0, 1.0 / torch.clamp(wsum, min=1e-30),
                           torch.zeros_like(wsum))
    dangling_f = (valid & (wsum <= 0)).to(torch.float32)
    return A["w"] * inv_wsum[A["src"]], dangling_f


def _pagerank_epilogue(rank, acc, env, P):
    """Fused epilogue: damping update + L1 convergence partial."""
    dangling_mass = torch.sum(rank * env["dangling_f"])
    new_rank = S.pagerank_update(acc, dangling_mass, env["valid_f"],
                                 env["n_f"], P["damping"])
    err = torch.sum(torch.abs(new_rank - rank))
    return new_rank, err


def graph_device(graph: DeviceGraph, device=None) -> torch.device:
    """The normalized device an entry point runs ``graph`` on: explicit,
    else the graph's (after ``graph.to_device``), else the card."""
    return resolve_device(device, like=None if graph.device is None
                          else graph.row_ptr)


def on_device(graph: DeviceGraph, dev: torch.device) -> DeviceGraph:
    """``graph`` with its arrays on the normalized device ``dev``."""
    placed = graph.device
    if placed is not None and resolve_device(placed) == dev:
        return graph
    return graph.to_device(dev)


def _build_lock(graph: DeviceGraph) -> threading.Lock:
    """The graph's own lock for its plan build and kernel placements."""
    with _mxu_locks_guard:
        lock = getattr(graph, "_mxu_build_lock", None)
        if lock is None:
            lock = threading.Lock()
            # DeviceGraph is frozen; bypass its setattr guard
            object.__setattr__(graph, "_mxu_build_lock", lock)
    return lock


# a delta larger than this fraction of the base edge set triggers a full
# replan (padding inflation + per-iteration delta cost outgrow the saving)
DELTA_RECOMPACT_FRACTION = 0.10


def _edge_diff(base_g: DeviceGraph, new_g: DeviceGraph, changed_gids):
    """Multiset edge diff restricted to vertices in changed_gids.
    Returns (added, removed) as (src, dst, w) tuples of host arrays, or
    None when the diff cannot be derived (node set changed, no host
    arrays kept, ...).  Reads ``host_coo``: nothing is copied back from
    the device."""
    if base_g.host_coo is None or new_g.host_coo is None:
        return None
    if base_g.n_nodes != new_g.n_nodes or \
            not np.array_equal(base_g.node_gids, new_g.node_gids):
        return None     # node set changed: dense ids shifted
    bitmap = np.zeros(new_g.n_nodes, dtype=bool)
    for gid in changed_gids:
        idx = new_g.gid_to_idx.get(gid)
        if idx is not None:
            bitmap[idx] = True
    os_, od, ow = base_g.host_coo
    ns_, nd, nw = new_g.host_coo
    o_sel = bitmap[os_]
    n_sel = bitmap[ns_]
    # multiset diff over (src, dst, w) rows: +1 for new, -1 for old;
    # weights compare as their int32 bits
    rows = np.stack([
        np.concatenate([ns_[n_sel].astype(np.int64),
                        os_[o_sel].astype(np.int64)]),
        np.concatenate([nd[n_sel].astype(np.int64),
                        od[o_sel].astype(np.int64)]),
        np.concatenate([nw[n_sel], ow[o_sel]]).view(np.int32).astype(
            np.int64),
    ], axis=1)
    sign = np.concatenate([np.ones(int(n_sel.sum()), dtype=np.int64),
                           -np.ones(int(o_sel.sum()), dtype=np.int64)])
    uniq, inv = np.unique(rows, axis=0, return_inverse=True)
    counts = np.zeros(len(uniq), dtype=np.int64)
    np.add.at(counts, inv.reshape(-1), sign)
    add_idx = np.repeat(np.arange(len(uniq)), np.maximum(counts, 0))
    rem_idx = np.repeat(np.arange(len(uniq)), np.maximum(-counts, 0))

    def w_back(col):
        return col.astype(np.int32).view(np.float32)

    added = (uniq[add_idx, 0], uniq[add_idx, 1], w_back(uniq[add_idx, 2]))
    removed = (uniq[rem_idx, 0], uniq[rem_idx, 1], w_back(uniq[rem_idx, 2]))
    return added, removed


def _try_delta_plan(graph: DeviceGraph):
    """Derive this snapshot's MXU state from a predecessor's full plan
    via an O(changed-edges) DeltaPlan.  None -> the caller does a full
    build.  The state keeps the base plan, the DeltaPlan and the base
    state, whose placed routes this snapshot's runs share."""
    from . import spmv_mxu
    ctx = getattr(graph, "_delta_ctx", None)
    if ctx is None:
        return None
    base_g, changed_gids = ctx
    base_state = getattr(base_g, "_mxu_state", None)
    # a delta-derived state anchors nothing: its plan is its own base's,
    # so a diff against its snapshot's edges would drop the first delta
    if base_state is None or base_state["plan"].wsum is None \
            or base_state.get("delta") is not None:
        return None
    t0 = time.perf_counter()
    diff = _edge_diff(base_g, graph, changed_gids)
    if diff is None:
        return None
    (a_s, a_d, a_w), (r_s, r_d, r_w) = diff
    n_delta = len(a_s) + len(r_s)
    if n_delta == 0:
        return base_state    # property-only bump: plan still exact
    if n_delta > max(DELTA_RECOMPACT_FRACTION * base_g.n_edges, 1024):
        return None          # recompact: full replan is the better deal
    diff_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    delta = spmv_mxu.build_delta_plan(base_state["plan"], a_s, a_d, a_w,
                                      r_s, r_d, r_w)
    return {"plan": base_state["plan"], "delta": delta, "base": base_state,
            "diff_s": diff_s, "delta_build_s": time.perf_counter() - t0,
            "runs": {}, "lock": _build_lock(graph)}


def _semiring_cache() -> dict:
    """The runs of other plus-times algorithms kept beside a plan state
    (``semiring_run``): {"plans": {normalize: plan}, "plan_s":
    {normalize: seconds to derive or build it}, "placed": {(normalize,
    device, route dtype): placed state}, "runs": {key: run}}."""
    return {"plans": {}, "plan_s": {}, "placed": {}, "runs": {}}


def _mxu_state(graph: DeviceGraph) -> dict:
    """The graph's MXU state, built once per snapshot and cached on it:
    a full build {"plan", "plan_build_s", "runs": {(device, route dtype):
    run}, "placed": {(device, route dtype): place_plan's state},
    "semiring": the other algorithms' runs on this plan
    (``semiring_run``), "lock": the graph's build lock}, devices
    normalized (``resolve_device``); or a delta refresh of a
    predecessor's (``_try_delta_plan``: "delta", "base", "diff_s" and
    "delta_build_s" in place of "plan_build_s" and "placed")."""
    state = getattr(graph, "_mxu_state", None)
    if state is not None:
        return state
    from . import spmv_mxu
    lock = _build_lock(graph)
    with lock:
        state = getattr(graph, "_mxu_state", None)
        if state is None:
            state = _try_delta_plan(graph)
            if state is not None:
                object.__setattr__(graph, "_mxu_state", state)
        if state is None:
            t0 = time.perf_counter()
            src, dst, w = graph.host_edges()
            plan = spmv_mxu.build_plan(src, dst, w, graph.n_nodes)
            state = {"plan": plan,
                     "plan_build_s": time.perf_counter() - t0, "runs": {},
                     "placed": {}, "semiring": _semiring_cache(),
                     "lock": lock}
            # DeviceGraph is frozen; bypass its setattr guard
            object.__setattr__(graph, "_mxu_state", state)
            # full plans anchor later delta refreshes
            object.__setattr__(graph, "_mxu_base_self", True)
    return state


def _placed(state: dict, device: torch.device, route_dtype) -> dict:
    """The base plan's placed routes on (device, route dtype): placed once
    on the full-build state that holds the plan, under its graph's lock,
    and shared by that snapshot's runs and every delta snapshot's, in
    whichever order they come."""
    from . import spmv_mxu
    base = state.get("base", state)
    key = (resolve_device(device), route_dtype)
    with base["lock"]:
        placed = base["placed"].get(key)
        if placed is None:
            placed = spmv_mxu.place_plan(base["plan"], route_dtype, device)
            base["placed"][key] = placed
    return placed


def _semiring_home(graph: DeviceGraph):
    """(home, shared): where a plus-times run other than PageRank's is
    cached.  A full-build state (PageRank's, or built here when the graph
    has none and is no delta snapshot) is shared: the run rides its plan
    and placed routes.  A delta snapshot's routes are another snapshot's,
    so it gets a home of its own on the graph, with plans of its own (as
    the reference builds them)."""
    state = getattr(graph, "_mxu_state", None)
    if state is None and getattr(graph, "_delta_ctx", None) is None:
        state = _mxu_state(graph)
    if state is not None and state.get("delta") is None:
        return state, True
    lock = _build_lock(graph)
    with lock:
        home = getattr(graph, "_mxu_semiring", None)
        if home is None:
            home = {"lock": lock, "semiring": _semiring_cache()}
            object.__setattr__(graph, "_mxu_semiring", home)
    return home, False


def semiring_run(graph: DeviceGraph, device: torch.device, *, epilogue,
                 normalize: bool, precision: str, cache_tag: str,
                 x0_default: str):
    """The placed MXU run of a plus-times fixpoint (``semiring.
    mxu_fixpoint``), cached per (cache_tag, normalize, precision,
    epilogue, x0_default, device), under the graph's own lock.

    On a shared full-build state the normalized plan is PageRank's and
    the unnormalized one is derived from it (``unnormalized_plan``: a new
    ``mult`` from the graph's edges, no route rebuilt); both ride
    PageRank's placed routes for the device and route dtype, the latter
    placing only its ``mult`` (``place_mult``).  On a home of its own the
    plan is built and placed in full.  The run carries ``out_relabel``
    (on the device) and ``plan``.

    The route dtype follows ``precision`` alone (bf16 or f32), as the
    reference's ``mxu_fixpoint`` fixes it; MEMGRAPH_TPU_ROUTE_DTYPE moves
    only PageRank's f32 routes.  With that variable at bf16, an f32 run
    here finds no f32 routes of PageRank's and places its own beside
    them: a second edge and node route on the device, the price of the
    reference's f32 answer."""
    from . import spmv_mxu
    route_dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    key = (cache_tag, bool(normalize), precision, epilogue, x0_default,
           device)
    home, shared = _semiring_home(graph)
    cache = home["semiring"]
    run = cache["runs"].get(key)
    if run is not None:
        return run
    # PageRank's routes first, under the same lock, taken and released
    base_placed = _placed(home, device, route_dtype) if shared else None
    with home["lock"]:
        run = cache["runs"].get(key)
        if run is None:
            plan = cache["plans"].get(bool(normalize))
            if plan is None:
                t0 = time.perf_counter()
                if shared and normalize:
                    plan = home["plan"]
                elif shared:
                    src, _, w = graph.host_edges()
                    plan = spmv_mxu.unnormalized_plan(home["plan"], src, w)
                else:
                    src, dst, w = graph.host_edges()
                    plan = spmv_mxu.build_plan(src, dst, w, graph.n_nodes,
                                               normalize=normalize)
                cache["plans"][bool(normalize)] = plan
                cache["plan_s"][bool(normalize)] = time.perf_counter() - t0
            pkey = (bool(normalize), device, route_dtype)
            placed = cache["placed"].get(pkey)
            if placed is None:
                if not shared:
                    placed = spmv_mxu.place_plan(plan, route_dtype, device)
                elif normalize:
                    placed = base_placed
                else:
                    placed = spmv_mxu.place_mult(base_placed, plan)
                cache["placed"][pkey] = placed
            run = spmv_mxu.make_semiring_kernel(
                plan, epilogue=epilogue, route_dtype=route_dtype,
                x0_default=x0_default, device=device, placed=placed)
            run.out_relabel = torch.from_numpy(plan.out_relabel).to(device)
            run.plan = plan
            cache["runs"][key] = run
    return run


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
    dtype it was not built for.

    On a delta snapshot every run routes the delta, whatever its dtype.
    The reference builds its bf16 run from the bare base plan
    (memgraph_tpu/ops/pagerank.py:_pagerank_via_mxu), so its bf16 ranks
    of a refreshed snapshot are the base snapshot's; the port does not
    copy that."""
    from . import spmv_mxu
    state = _mxu_state(graph)
    plan = state["plan"]
    route_dtype = spmv_mxu.resolve_route_dtype(_ROUTE_DTYPES[precision])
    key = (resolve_device(device), route_dtype)
    run = state["runs"].get(key)
    if run is None:
        # the base routes first, under the base graph's lock; then the
        # run (and its delta) under the lock of the state's own graph
        placed = _placed(state, device, route_dtype)
        with state["lock"]:
            run = state["runs"].get(key)
            if run is None:
                run = spmv_mxu.make_pagerank_kernel(
                    plan, route_dtype=route_dtype, device=device,
                    delta=state.get("delta"), placed=placed)
                run.out_relabel = torch.from_numpy(plan.out_relabel).to(
                    device)
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
             precision: str = "f32", x0=None, device=None, mesh=None):
    """Returns (ranks[:n_nodes] as a tensor on the device, error,
    iterations).

    ``device`` — where to run: explicit, else the graph's device (after
    ``graph.to_device``), else the card.  Without a card and without an
    explicit CPU request this raises.

    ``mesh`` — routes through the mesh (parallel/analytics.py
    ``pagerank_mesh``): a MeshContext, a shard count, a tuple of devices,
    or None (MEMGRAPH_TPU_MESH_DEVICES; unset keeps the single-card
    routes).  A mesh of 1 runs the same sharded code as any other size.

    ``precision`` — "f32" (exact), "bf16" (contributions rounded, f32
    accumulation) or "int8" (quantized streaming; segment backend only);
    error bounds: semiring.PRECISION_BOUNDS.

    ``x0`` — optional (n_nodes,) previous solution; warm-starts the
    fixpoint (PageRank is a contraction, any seed converges to the same
    answer at the same tol — the seed only cuts the iteration count).
    """
    S._check_precision(precision)
    dev = graph_device(graph, device)
    backend, ctx = S.route_backend(graph, dev, mesh, precision=precision,
                                   min_edges=MXU_MIN_EDGES)
    if backend == "mesh":
        from ..parallel.analytics import pagerank_mesh
        return pagerank_mesh(graph, ctx, damping=damping,
                             max_iterations=max_iterations, tol=tol,
                             precision=precision, x0=x0)
    if backend == "mxu":
        return _pagerank_via_mxu(graph, dev, damping, max_iterations, tol,
                                 precision, x0=x0)
    g = on_device(graph, dev)
    x0_pad = None
    if x0 is not None:
        x0 = np.asarray(x0, dtype=np.float32)[:g.n_nodes]
        total = float(x0.sum())
        if np.isfinite(total) and total > 0.0:
            buf = np.zeros(g.n_pad, dtype=np.float32)
            buf[:len(x0)] = x0 / np.float32(total)
            x0_pad = torch.from_numpy(buf).to(dev)
    rank, err, iters = S.fixpoint(
        "plus_times", arrays=_pull_arrays(g),
        params={"n_nodes": g.n_nodes, "damping": f32_scalar(damping, dev),
                "tol": np.float32(tol)},
        n_out=g.n_pad, setup=_pagerank_setup,
        epilogue=_pagerank_epilogue, max_iterations=max_iterations,
        sorted=True, precision=precision, x0=x0_pad)
    return rank[:g.n_nodes], err, iters


def f32_scalar(v, dev):
    """A float32 scalar on the device: the update's arithmetic stays in
    float32, as the reference's np.float32 parameters keep it."""
    return torch.tensor(float(np.float32(v)), dtype=torch.float32,
                        device=dev)


def _pull_arrays(g: DeviceGraph) -> dict:
    """The edge arrays of a pull (CSC) plus-times fixpoint, with the run
    offsets of the true edges: ``dst_ptr`` (CSC) and ``csr_ptr`` (CSR),
    and the longest run of each (``dst_longest``, ``csr_longest``)."""
    return {"src": g.csc_src, "dst": g.csc_dst, "w": g.csc_weights,
            "dst_ptr": g.csc_runs(), "dst_longest": g.longest_csc_run,
            "csr_src": g.src_idx, "csr_w": g.weights, "csr_ptr": g.row_ptr,
            "csr_longest": g.longest_csr_run}


# ---------------------------------------------------------------------------
# personalized PageRank
# ---------------------------------------------------------------------------
#
# One PPR is a fixpoint over an (n_pad, 1) iterate; a batch of B is the
# same over (n_pad, B) lanes, one SpMM an iteration.  Every reduction of
# the loop is B-independent: the matvec is the run sum (segment_cuda
# ``csr_spmm_sum``), and the restart vectors' normalization, the dangling
# mass and the L1 error are ``lane_sum``s.  Elementwise work is the same
# per element whatever B is, so a lane of a batch is bit-equal to the
# sequential run of its sources, on the CPU and on the card.

#: batch lanes are padded up to these bucket widths, as the reference
#: pads them to reuse its compiled programs
_PPR_LANE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)


def _bucket_lanes(b: int) -> int:
    for cap in _PPR_LANE_BUCKETS:
        if b <= cap:
            return cap
    return b


def _ppr_setup(A, P, n_out):
    """PPR invariants: the restart vectors (n_out, B), each normalized to
    unit mass, and the hoisted multipliers."""
    valid = torch.arange(n_out, device=A["src"].device) < P["n_nodes"]
    p = A["personalization"] * valid.to(torch.float32).unsqueeze(1)
    p = p / torch.clamp(SC.lane_sum(p), min=1e-30)
    edge_mult, dangling_f = _hoisted(A, valid, n_out)
    return {"w": edge_mult, "p": p, "dangling_f": dangling_f, "x0": p}


def _ppr_epilogue(rank, acc, env, P):
    """Fused PPR update: restart mass flows to each lane's personalization
    vector (dangling mass included); the L1 error a lane."""
    p = env["p"]
    dangling_mass = SC.lane_sum(rank, m=env["dangling_f"])
    new_rank = (1.0 - P["damping"]) * p \
        + P["damping"] * (acc + dangling_mass * p)
    return new_rank, SC.lane_sum(new_rank, rank)


def _ppr_params(g: DeviceGraph, damping, tol, dev) -> dict:
    return {"n_nodes": g.n_nodes, "damping": f32_scalar(damping, dev),
            "tol": np.float32(tol)}


def personalized_pagerank(graph: DeviceGraph, source_nodes,
                          damping: float = 0.85, max_iterations: int = 100,
                          tol: float = 1e-6, precision: str = "f32",
                          kernel=None, kernel_meta: dict | None = None,
                          device=None):
    """PPR with restart mass on ``source_nodes`` (dense indices).  Returns
    (ranks[:n_nodes] as a tensor on the device, error, iterations).

    ``kernel`` routes the call through a resident kernel server's
    coalescing plane (server/kernel_server.py): a socket path (True, "1"
    or "default": the port's default socket) or a client; ``kernel_meta``
    carries the request's serving fields (``graph_key``,
    ``graph_version``, the delta payload, ``send_graph``).
    A failure of the plane falls back to the in-process run, on the same
    device, loudly (``_ppr_via_kernel``).  A routed answer may be the
    plane's cache hit of an older version when the commits since touched
    nothing within one hop of the sources (the reference's invalidation;
    ROADMAP Queue 3 item 6).  ``device``: explicit, else the graph's,
    else the card."""
    S._check_precision(precision)
    dev = graph_device(graph, device)
    if kernel is not None:
        got = _ppr_via_kernel(graph, source_nodes, damping, max_iterations,
                              tol, precision, kernel, kernel_meta, dev)
        if got is not None:
            return got
    g = on_device(graph, dev)
    p = torch.zeros(g.n_pad, 1, dtype=torch.float32, device=dev)
    p[torch.as_tensor(np.asarray(source_nodes, dtype=np.int64),
                      device=dev)] = 1.0
    rank, err, iters = S.fixpoint(
        "plus_times", arrays={**_pull_arrays(g), "personalization": p},
        params=_ppr_params(g, damping, tol, dev), n_out=g.n_pad,
        setup=_ppr_setup, epilogue=_ppr_epilogue,
        max_iterations=max_iterations, sorted=True, precision=precision)
    return rank[:g.n_nodes, 0], err, iters


def _ppr_via_kernel(graph, source_nodes, damping, max_iterations, tol,
                    precision, kernel, kernel_meta, dev):
    """One PPR through the resident server's coalescing plane: (ranks as
    a tensor on ``dev``, err, iters), counted in
    ``analytics.kernel_routed_total``; None when the plane fails (a typed
    failure, a lost or absent daemon), logged and counted in
    ``analytics.kernel_route_fallback_total``, and the caller runs in
    process.  The graph's edges ride along unless ``send_graph`` is
    False; the graph key defaults to one of this snapshot object."""
    import logging
    from ..server import kernel_server as ks
    from ..utils.metrics import global_metrics
    meta = dict(kernel_meta or {})
    try:
        _, client = ks.route_client(kernel)
        send_graph = meta.pop("send_graph", True)
        meta.pop("top_k", None)    # this entry point returns full ranks
        kwargs = {}
        if send_graph:
            src, dst, w = graph.host_coo if graph.host_coo is not None \
                else graph.host_edges()
            kwargs.update(src=np.asarray(src, dtype=np.int64),
                          dst=np.asarray(dst, dtype=np.int64),
                          weights=np.asarray(w, dtype=np.float32))
        meta.setdefault("graph_key",
                        f"ppr:{id(graph)}:{graph.n_nodes}:{graph.n_edges}")
        h, out = client.ppr(
            sources=np.asarray(source_nodes, dtype=np.int32),
            n_nodes=graph.n_nodes, damping=float(damping),
            max_iterations=int(max_iterations), tol=float(tol),
            precision=precision, **meta, **kwargs)
        global_metrics.increment("analytics.kernel_routed_total")
        ranks = np.array(out["ranks"][:graph.n_nodes], dtype=np.float32)
        return (torch.from_numpy(ranks).to(dev), float(h.get("err", 0.0)),
                int(h.get("iters", 0)))
    except (ks.KernelServerError, ConnectionError, OSError) as e:
        global_metrics.increment("analytics.kernel_route_fallback_total")
        logging.getLogger(__name__).warning(
            "kernel-server PPR route failed (%s: %s); falling back to the "
            "in-process path", type(e).__name__, e)
        return None


def personalized_pagerank_batch(graph: DeviceGraph, source_sets,
                                damping: float = 0.85,
                                max_iterations: int = 100,
                                tol: float = 1e-6, precision: str = "f32",
                                x0=None, raw: bool = False, device=None):
    """B independent PPR fixpoints as one SpMM power iteration.

    ``source_sets`` is a list of dense-index lists (one per lane) or a
    prebuilt (n_pad, B) personalization matrix.  ``x0`` optionally seeds
    the lanes ((n_pad, B), a warm start: any seed converges to the same
    fixpoint, in fewer iterations).

    Returns (ranks (B, n_nodes), err (B,), iters (B,)) as host arrays.
    Lanes are padded up to ``_PPR_LANE_BUCKETS``; padding lanes restart
    on lane 0's sources and are dropped.  A lane that converges freezes
    at its stopping iterate, so it is bit-equal to the sequential
    ``personalized_pagerank`` of its sources, with the same iteration
    count.  The loop stops once every lane is done or after
    ``max_iterations``, read on the host once an iteration.  ``raw=True``
    returns the device (n_pad, n_lanes) iterate, padding lanes included,
    with err and iters as device tensors."""
    S._check_precision(precision)
    dev = graph_device(graph, device)
    if getattr(source_sets, "ndim", None) == 2:
        pm = np.asarray(source_sets, dtype=np.float32)
        n_req = pm.shape[1]
    else:
        n_req = len(source_sets)
        pm = np.zeros((graph.n_pad, n_req), dtype=np.float32)
        for lane, sources in enumerate(source_sets):
            pm[np.asarray(sources, dtype=np.int64), lane] = 1.0
    if n_req == 0:
        return (np.zeros((0, graph.n_nodes), dtype=np.float32),
                np.zeros(0, dtype=np.float32), np.zeros(0, dtype=np.int32))
    n_lanes = _bucket_lanes(n_req)
    if n_lanes > n_req:
        pad = np.repeat(pm[:, :1], n_lanes - n_req, axis=1)
        pm = np.concatenate([pm, pad], axis=1)
    if x0 is not None:
        x0 = np.asarray(x0, dtype=np.float32)
        if x0.shape[1] < n_lanes:
            pad = np.repeat(pm[:, -1:], n_lanes - x0.shape[1], axis=1)
            x0 = np.concatenate([x0, pad], axis=1)
    g = on_device(graph, dev)
    A = {**_pull_arrays(g),
         "personalization": torch.from_numpy(pm).to(dev)}
    P = _ppr_params(g, damping, tol, dev)
    env = _ppr_setup(A, P, g.n_pad)
    x = (torch.from_numpy(np.ascontiguousarray(x0)).to(dev)
         if x0 is not None else env["x0"])
    tol_t = torch.tensor(np.float32(tol), device=dev)
    done = torch.zeros(n_lanes, dtype=torch.bool, device=dev)
    err = torch.full((n_lanes,), float("inf"), dtype=torch.float32,
                     device=dev)
    iters = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
    it = 0
    while it < max_iterations and not bool(done.all()):
        acc = S.spmv("plus_times", x, A["src"], A["dst"], env["w"],
                     n_out=g.n_pad, sorted=True, precision=precision,
                     ptr=A["dst_ptr"], longest=A["dst_longest"])
        new_x, new_err = _ppr_epilogue(x, acc, env, P)
        # freeze converged lanes: their iterate is exactly the
        # sequential loop's stopping state
        x = torch.where(done, x, new_x)
        err = torch.where(done, err, new_err)
        iters = torch.where(done, iters, iters + 1)
        done = done | (err <= tol_t)
        it += 1
    if raw:
        return x, err, iters
    ranks = x[:g.n_nodes, :n_req].T.cpu().numpy()
    return ranks, err[:n_req].cpu().numpy(), iters[:n_req].cpu().numpy()


def ppr_topk(ranks_matrix, n_nodes: int, k: int, raw: bool = False,
             device=None):
    """Per-lane top-k over a (B, n) rank matrix, on the device.  Ties go
    to the lower index, as ``jax.lax.top_k`` breaks them (a stable
    descending sort; ``torch.topk`` on CUDA promises no order among
    ties).

    Returns (values (B, k), indices (B, k) int32) as host arrays, or as
    device tensors with ``raw=True``.  ``device``: explicit, else the
    matrix's when it is a tensor, else the card."""
    if isinstance(ranks_matrix, torch.Tensor):
        m = ranks_matrix
        dev = resolve_device(device, like=m)
    else:
        m = torch.from_numpy(np.asarray(ranks_matrix, dtype=np.float32))
        dev = resolve_device(device)
    m = m.to(dev)[:, :n_nodes]
    k = max(1, min(int(k), int(n_nodes)))
    vals, idx = torch.sort(m, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k].to(torch.int32)
    if raw:
        return vals, idx
    return vals.cpu().numpy(), idx.cpu().numpy()
