"""Multi-shard MXU PageRank: the Benes/MXU route sharded over the edges of
a mesh (parallel/mesh.py).

Port of memgraph_tpu/ops/spmv_mxu_sharded.py.  Decomposition:

  - every shard holds ~E/P edges (``_assign_shards``: the balanced edge
    coloring of native/edge_color.cpp for a power-of-two shard count, so
    every node's edges split evenly over the shards on both sides; a
    round robin within each src's edges otherwise), which divides the
    per-row gather heights and the Benes net ~P-fold;
  - the node LABELINGS (out / in) are global and shared, so every shard's
    extract produces a partial accumulator in the same in-label layout
    (n_drows_p x 128), and the per-shard layouts are padded to one size
    (R_G, C and the net: the plan stacks them on a leading shard axis);
  - one ``psum`` a iteration combines the partial accumulators;
  - the node relabel route, the dangling correction and the damping
    update run replicated (once a distinct device).

A shard's edge phase is the single-card route's (ops/spmv_mxu.py
``_route_acc``): the expand ``bmm``, the Benes route on the hand-written
gathers of ops/benes_cuda.py (``benes_mid_gather`` /
``benes_outer_gather``; the stage kernels ``benes_mid`` / ``benes_outer``
compose the shard's route at placement) and the one-hot extract.  Each
shard's layout and route rows go to its device as one pinned blob
(ops/blob.py ``put_packed``).  The route dtype defaults to bfloat16, as
in the reference.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..device import exact_f32_matmuls
from .benes_cuda import (K_BY_DTYPE, benes_apply, build_masks, compose_mid,
                         compose_outer)
from .blob import put_packed
from .semiring import pagerank_update
from .spmv_mxu import (K_C, LANES, R_C, SG_ROWS, _edge_perm_masks,
                       _flat_layout, _gather_layout, _global_labelings,
                       _node_relabel_masks, _route_acc, _scatter_layout)


@dataclass
class ShardedMXUPlan:
    n_nodes: int
    n_shards: int
    G: int
    R_G: int                   # uniform across shards (max)
    net_log2: int              # shared net size (max over shards)
    C: int                     # uniform extract chunks (max, padded)
    W: int
    n_drows_p: int
    # --- per shard, stacked on axis 0 ---
    rowid: np.ndarray          # (P, G, R_G) int16
    mult: np.ndarray           # (P, G, R_G, LANES) f32
    masks_packed: np.ndarray   # (P, stages, N/8) uint8
    run_k: np.ndarray          # (P, C, R_C) int16
    win_oh: np.ndarray         # (P, C, W) f32
    # --- global (replicated) ---
    out_relabel: np.ndarray
    in_relabel: np.ndarray
    valid_out: np.ndarray
    dangling_out: np.ndarray
    node_net_log2: int
    node_masks_packed: np.ndarray


def _assign_shards(src, dst, n_nodes, n_shards):
    """Edge -> shard.  The plan's padding follows each 128-node row's
    largest per-shard degree, so balance matters more than randomness:
    the native balanced coloring for a power-of-two count; else (or
    without a compiler) a round robin within each src's edges."""
    levels = int(np.log2(n_shards))
    if (1 << levels) == n_shards and levels > 0:
        from .native import balanced_edge_color_native
        shard = balanced_edge_color_native(src, dst, n_nodes, n_nodes,
                                           levels)
        if shard is not None:
            return shard.astype(np.int64)
    order = np.argsort(src, kind="stable")
    seq = np.arange(len(src)) - np.concatenate(
        ([0], np.cumsum(np.bincount(src, minlength=n_nodes))))[src[order]]
    shard = np.empty(len(src), dtype=np.int64)
    shard[order] = seq % n_shards
    return shard


def build_sharded_plan(src: np.ndarray, dst: np.ndarray,
                       weights: Optional[np.ndarray], n_nodes: int,
                       n_shards: int) -> ShardedMXUPlan:
    """Per-shard gather / scatter layouts and Benes nets under SHARED
    global node labelings, padded to one size so they stack on a leading
    shard axis (the reference's arrays, one for one)."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    E = len(src)
    w = (np.ones(E, dtype=np.float64) if weights is None
         else np.asarray(weights, dtype=np.float64))
    (G, relab_out, relab_in, inv_wsum, valid_out, dangling_out,
     n_drows_p, _wsum) = _global_labelings(src, dst, w, n_nodes)

    shard_of = _assign_shards(src, dst, n_nodes, n_shards)
    subs = [(src[shard_of == p], dst[shard_of == p], w[shard_of == p])
            for p in range(n_shards)]
    # the uniform R_G first: the gather positions depend on it
    req_R_G = []
    for s_src, _, _ in subs:
        u = relab_out[s_src]
        deg_l = np.bincount(u, minlength=G * SG_ROWS * LANES)
        H = deg_l.reshape(-1, LANES).max(axis=1)
        req_R_G.append(max(1, int(H.reshape(G, SG_ROWS).sum(axis=1).max())))
    R_G = max(req_R_G)
    gathers = [_gather_layout(s_src, s_w, relab_out, inv_wsum, G,
                              force_R_G=R_G) for s_src, _, s_w in subs]
    scatters = [_scatter_layout(s_dst, relab_in, n_drows_p)
                for _, s_dst, _ in subs]
    C = max(sc[0] for sc in scatters)
    W = n_drows_p // K_C
    net = max(G * R_G * LANES, max(sc[4] for sc in scatters) * LANES, 2)
    net_log2 = int(np.ceil(np.log2(net)))
    rowid = np.stack([g[1] for g in gathers])
    mult = np.stack([g[2] for g in gathers])
    # the shards' nets route independently: one thread each (the native
    # router runs outside the GIL), the same masks as one after another
    with ThreadPoolExecutor(max_workers=n_shards) as pool:
        masks = np.stack(list(pool.map(
            lambda gs: _edge_perm_masks(gs[0][3], gs[1][3], net_log2),
            zip(gathers, scatters))))
    # uniform C: padding chunks are run_k == -1 (never extracted) with
    # all-zero win_oh rows
    run_k = np.full((n_shards, C, R_C), -1, dtype=np.int16)
    win_oh = np.zeros((n_shards, C, W), dtype=np.float32)
    for p, sc in enumerate(scatters):
        run_k[p, :sc[0]] = sc[1]
        win_oh[p, :sc[0]] = sc[2]
    node_net_log2, node_masks_packed = _node_relabel_masks(
        relab_out, relab_in, G * SG_ROWS * LANES, n_drows_p)
    return ShardedMXUPlan(
        n_nodes=n_nodes, n_shards=n_shards, G=G, R_G=R_G,
        net_log2=net_log2, C=C, W=W, n_drows_p=n_drows_p, rowid=rowid,
        mult=mult, masks_packed=masks, run_k=run_k, win_oh=win_oh,
        out_relabel=relab_out, in_relabel=relab_in, valid_out=valid_out,
        dangling_out=dangling_out, node_net_log2=node_net_log2,
        node_masks_packed=node_masks_packed)


def _route_arrays(masks_packed, net_log2, dtype, prefix: str):
    """A net's live mask rows as blob entries, and its spec."""
    spec, mid, outer = build_masks(masks_packed, net_log2, K_BY_DTYPE[dtype])
    arrays = {prefix + "mid": ("bits", mid)}
    if outer is not None:
        arrays[prefix + "outer"] = ("bits", outer)
    return arrays, spec, mid.shape[-1]


def _rows(words, row_bytes: int):
    """Packed mask rows (uint8) back from their blob words."""
    return words.view(torch.uint8).view(
        words.shape[0], words.shape[-1] * 4)[:, :row_bytes].contiguous()


def _compose(t, spec, prefix: str, row_bytes: int):
    mid = compose_mid(_rows(t[prefix + "mid"], row_bytes), spec)
    outer = (compose_outer(_rows(t[prefix + "outer"], row_bytes), spec)
             if prefix + "outer" in t else None)
    return mid, outer, spec


def _layout(t):
    """(oh, mult, ohe_t, win_oh_t) from a shard's placed arrays, as
    spmv_mxu._put_layout builds them."""
    dev = t["rowid"].device
    rowid, run_k = t["rowid"].long(), t["run_k"].long()
    oh = (rowid[:, :, None] == torch.arange(SG_ROWS, device=dev)
          ).to(torch.float32)
    ohe_t = ((run_k[:, :, None] == torch.arange(K_C, device=dev))
             & (run_k[:, :, None] >= 0)
             ).to(torch.float32).transpose(1, 2).contiguous()
    return oh, t["mult"], ohe_t, t["win_oh"].T.contiguous()


def make_sharded_pagerank_kernel(plan: ShardedMXUPlan, ctx,
                                 route_dtype=None):
    """Returns fn(rank0_flat, damping, max_iter, tol) -> (rank_flat, err,
    iters), the edge phase sharded over ``ctx`` with one ``psum`` an
    iteration; rank vectors are replicated, flat in OUT labeling.
    ``route_dtype`` defaults to torch.bfloat16 (the reference's)."""
    from ..parallel.mesh import psum, replicated
    if route_dtype is None:
        route_dtype = torch.bfloat16
    if plan.n_shards != ctx.n_shards:
        raise ValueError(f"plan built for {plan.n_shards} shards but the "
                         f"mesh has {ctx.n_shards}")
    t0 = time.perf_counter()
    G = plan.G
    N_nn = 1 << plan.node_net_log2
    node_flat = G * SG_ROWS * LANES
    n_f = float(plan.n_nodes)
    shards = []
    for p, dev in enumerate(ctx.devices):
        arrays, spec, row_bytes = _route_arrays(
            plan.masks_packed[p], plan.net_log2, route_dtype, "")
        arrays.update(rowid=plan.rowid[p].astype(np.int32),
                      run_k=plan.run_k[p].astype(np.int32),
                      mult=plan.mult[p].astype(np.float32),
                      win_oh=plan.win_oh[p].astype(np.float32))
        t = put_packed(arrays, dev)              # one upload a shard
        shards.append({"route": _compose(t, spec, "", row_bytes),
                       "layout": _layout(t)})
    g_arrays, g_spec, g_bytes = _route_arrays(
        plan.node_masks_packed, plan.node_net_log2, torch.float32, "node_")
    g_arrays.update(valid=plan.valid_out.astype(np.float32),
                    dangling=plan.dangling_out.astype(np.float32))

    def place_global(dev):
        t = put_packed(g_arrays, dev)
        return {"node": _compose(t, g_spec, "node_", g_bytes),
                "valid": t["valid"], "dangling": t["dangling"]}

    env = replicated(ctx, place_global, list(ctx.devices))
    ctx.synchronize()
    placement_s = time.perf_counter() - t0

    def edge_phase(p, rank_flat):
        sh = shards[p]
        return _route_acc(rank_flat.view(G, SG_ROWS, LANES), sh["layout"],
                          sh["route"], route_dtype)

    def node_phase(acc_w, rank, e, d):
        xa = torch.zeros(N_nn, dtype=torch.float32, device=rank.device)
        xa[:acc_w.numel()] = acc_w.reshape(-1)
        acc = benes_apply(xa.view(_flat_layout(N_nn)), *e["node"]
                          ).reshape(-1)[:node_flat]
        dm = torch.sum(rank * e["dangling"])
        new = pagerank_update(acc, dm, e["valid"], n_f, d)
        return new, torch.sum(torch.abs(new - rank))

    def run(rank0, damping, max_iterations, tol):
        exact_f32_matmuls()       # the one-hot matmuls carry rank values
        rank = list(ctx.put_replicated(np.asarray(rank0, dtype=np.float32)))
        d = replicated(ctx, lambda dev: torch.tensor(
            float(np.float32(damping)), device=dev), list(ctx.devices))
        tol = float(np.float32(tol))
        err, it = float("inf"), 0
        while err > tol and it < max_iterations:
            acc = psum(ctx, [edge_phase(p, rank[p])
                             for p in range(ctx.n_shards)])
            out = replicated(ctx, node_phase, acc, rank, env, d)
            rank = [o[0] for o in out]
            err = float(out[0][1])
            it += 1
        return rank[0], err, it

    run.placement_s = placement_s
    run.routes = [sh["route"] for sh in shards]
    run.node_routes = [env[ctx.devices.index(d)]["node"]
                       for d in ctx.distinct]
    return run


def pagerank_mxu_sharded(src, dst, weights, n_nodes, mesh,
                         damping=0.85, max_iterations=100, tol=1e-6,
                         plan: ShardedMXUPlan = None, route_dtype=None):
    """End-to-end sharded MXU PageRank over ``mesh`` (a MeshContext, or
    what parallel/mesh.py ``resolve_mesh`` takes).  Returns ranks in
    ORIGINAL node ids (a tensor on the mesh's first device), err, iters.
    The placed kernel is cached on the plan per (mesh, route dtype)."""
    from ..parallel.mesh import resolve_mesh
    ctx = resolve_mesh(mesh)
    if plan is None:
        plan = build_sharded_plan(src, dst, weights, n_nodes, ctx.n_shards)
    cache = getattr(plan, "_kernel_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(plan, "_kernel_cache", cache)
    key = (ctx.cache_key, None if route_dtype is None else str(route_dtype))
    run = cache.get(key)
    if run is None:
        run = cache[key] = make_sharded_pagerank_kernel(
            plan, ctx, route_dtype=route_dtype)
    rank0 = np.zeros(plan.G * SG_ROWS * LANES, dtype=np.float32)
    rank0[plan.out_relabel] = 1.0 / plan.n_nodes
    rank, err, iters = run(rank0, damping, max_iterations, tol)
    relabel = torch.from_numpy(plan.out_relabel.astype(np.int64)).to(
        rank.device)
    return rank[relabel], float(err), int(iters)
