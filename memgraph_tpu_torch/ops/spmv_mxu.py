"""Gather-free sparse matvec (PageRank core) from matmuls and Benes routing.

Port of memgraph_tpu/ops/spmv_mxu.py.  ``acc[dst] += rank[src] *
mult(edge)`` is computed with no data-dependent addressing on the device:

  1. EXPAND   — one-hot matmul multicast: per supergroup of 128 rank rows,
                T = OH(src_row) @ rank_planes places rank[src] in every
                edge slot (slot lane == src & 127); multiply by the
                per-slot `mult` (weight / out-weight-sum, 0 on padding).
  2. PERMUTE  — a Benes network moves every edge slot from its
                gather-layout position to its scatter-layout position
                (ops/benes_cuda.py: hand-written CUDA kernels on the card;
                the middle stages run as one placed tile-local gather).
  3. REDUCE + EXTRACT — scatter layout keeps each destination's edges
                contiguous within its lane (lane == dst & 127, runs
                aligned per dst-row); a full-run one-hot matmul per chunk
                sums every run:
                per_chunk[c,k,l] = sum_i OH(run slot)[c,i,k] * x[c,i,l],
                then a small window one-hot sums chunks into aligned
                windows.
  4. RELABEL  — a second (node-sized) Benes converts the accumulator from
                the in-degree-sorted labeling (which keeps scatter padding
                small under skew) to the out-degree-sorted labeling (which
                keeps gather padding small), ready for the next EXPAND.

All routing, masks and layouts are computed on the host (numpy, the same
code as the JAX package, so both packages build identical plans) and
placed on the device once per plan, device and route dtype
(``place_plan``); a snapshot refresh adds a ``DeltaPlan`` side-net,
placed by ``make_semiring_kernel``.
"""

from __future__ import annotations

import dataclasses
import os
import time
import zipfile
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..device import exact_f32_matmuls, resolve_device
from .benes import route_packed
from .benes_cuda import (K_BY_DTYPE, benes_apply, build_masks, compose_mid,
                         compose_outer)
from .semiring import pagerank_update

LANES = 128
SG_ROWS = 128          # rank rows per supergroup (=> 16384 nodes)
R_C = 256              # scatter rows per extract chunk
K_C = 256              # dst-rows per aligned output window

#: plans built in this process: "build_plan" (a full build) and
#: "build_delta_plan" (a snapshot refresh's side-net); the kernel server's
#: health reply ships them, so a client sees how a generation was planned
plan_counts = {"build_plan": 0, "build_delta_plan": 0}


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass
class MXUPlan:
    n_nodes: int
    # --- gather (out-degree labeling) ---
    G: int                     # supergroups
    R_G: int                   # gather rows per supergroup (padded uniform)
    rowid: np.ndarray          # (G, R_G) int16: src row within supergroup
    mult: np.ndarray           # (G, R_G, LANES) f32: w/wsum, 0 = pad slot
    out_relabel: np.ndarray    # (n_nodes,) original -> out-label id
    valid_out: np.ndarray      # (G*SG_ROWS*LANES,) f32 1.0 for real nodes
    dangling_out: np.ndarray   # same shape: 1.0 where out-wsum == 0
    # --- big Benes ---
    net_log2: int
    masks_packed: np.ndarray   # (stages, N/8) uint8
    # --- scatter/extract (in-degree labeling) ---
    C: int                     # extract chunks (total rows = C * R_C)
    run_k: np.ndarray          # (C, R_C) int16: window slot of the row's
    #                            dst block (dr % K_C), -1 on padding rows
    win_oh: np.ndarray         # (C, W) f32 one-hot chunk->window
    W: int
    in_relabel: np.ndarray     # (n_nodes,) original -> in-label id
    # --- node relabel Benes (in-label acc -> out-label acc) ---
    node_net_log2: int
    node_masks_packed: np.ndarray
    # per-node out-weight sums (ORIGINAL ids) — the delta-refresh path
    # rescales stale w/wsum multipliers with these (see DeltaPlan)
    wsum: np.ndarray = None


def _relabel_by(key: np.ndarray, stripe_groups: int = 0) -> np.ndarray:
    """relabel[node] = position when sorted by key desc (stable).

    With stripe_groups=G, rows of 128 consecutive sorted nodes (degree-
    homogeneous, so each row's max ~ its mean) are dealt round-robin
    across the G supergroups: row j lands at supergroup j%G, slot j//G.
    This balances per-supergroup row totals so the uniform R_G padding of
    the batched expand einsum stays ~1x instead of concentrating all the
    tall rows in supergroup 0."""
    order = np.argsort(-key, kind="stable")
    n = len(key)
    pos = np.arange(n)
    if stripe_groups:
        j, lane = pos >> 7, pos & 127
        r2 = (j % stripe_groups) * SG_ROWS + j // stripe_groups
        pos = r2 * LANES + lane
    relab = np.empty(n, dtype=np.int64)
    relab[order] = pos
    return relab


def _gather_layout(src, w, relab_out, inv_wsum, G, force_R_G=None):
    """Gather-side layout for an edge subset under a FIXED out labeling.

    Returns (R_G, rowid, mult, gp_by_edge): rows per supergroup, the
    src-row id of every gather row, the per-slot multiplier (w/wsum,
    0 on padding), and each edge's flat gather position (edge order).

    force_R_G: use this (>= required) row count so plans for different
    edge shards stack into uniform arrays.
    """
    E = len(src)
    node_flat = G * SG_ROWS * LANES
    u = relab_out[src]
    srow, slane = u >> 7, u & 127
    # per-edge count per labeled node (LOCAL to this subset)
    deg_l = np.bincount(u, minlength=node_flat)
    # rows per src-row block = max subset-degree among its 128 nodes
    H_out = deg_l.reshape(-1, LANES).max(axis=1)              # per src-row
    rows_per_sg = H_out.reshape(G, SG_ROWS).sum(axis=1)
    R_G = max(1, int(rows_per_sg.max()))
    if force_R_G is not None:
        if force_R_G < R_G:
            raise ValueError(f"force_R_G={force_R_G} < required {R_G}")
        R_G = force_R_G
    # base row (within supergroup) of each src-row block
    base_in_sg = np.zeros(G * SG_ROWS, dtype=np.int64)
    for g in range(G):
        base_in_sg[g * SG_ROWS:(g + 1) * SG_ROWS] = \
            np.cumsum(H_out[g * SG_ROWS:(g + 1) * SG_ROWS]) \
            - H_out[g * SG_ROWS:(g + 1) * SG_ROWS]
    # per-edge sequence within its (node) bucket, in (src) sorted order
    order_g = np.argsort(u, kind="stable")
    seq = np.arange(E) - np.concatenate(([0], np.cumsum(
        deg_l)))[u[order_g]]
    sg = srow[order_g] >> 7
    grow = base_in_sg[srow[order_g]] + seq                    # row in sg
    gather_pos = ((sg * R_G + grow) * LANES + slane[order_g])

    rowid = np.zeros((G, R_G), dtype=np.int16)
    for g in range(G):
        rs = H_out[g * SG_ROWS:(g + 1) * SG_ROWS]
        rowid[g, :rs.sum()] = np.repeat(np.arange(SG_ROWS, dtype=np.int16),
                                        rs)
    mult = np.zeros((G, R_G, LANES), dtype=np.float32)
    mult_flat = mult.reshape(-1)
    mult_flat[gather_pos] = (w * inv_wsum[src])[order_g]
    gp_by_edge = np.empty(E, dtype=np.int64)
    gp_by_edge[order_g] = gather_pos
    return R_G, rowid, mult, gp_by_edge


def _scatter_layout(dst, relab_in, n_drows_p):
    """Scatter/extract layout for an edge subset under a FIXED in
    labeling. n_drows_p: dst-row count padded to whole K_C windows.

    Returns (C, run_k, win_oh, sp_by_edge, R_total).
    """
    E = len(dst)
    W = n_drows_p // K_C
    v = relab_in[dst]
    drow, dlane = v >> 7, v & 127
    cnt = np.bincount(v, minlength=n_drows_p * LANES)
    H_in = np.maximum(cnt.reshape(-1, LANES).max(axis=1), 1)[:n_drows_p]

    # chunked row allocation: the full-run one-hot extract sums EVERY row
    # of a dst block, so every row of a block must live in chunks claimed
    # by the block's window — pad to a chunk boundary whenever a block
    # would otherwise share a chunk with a different window.
    base2 = np.zeros(n_drows_p, dtype=np.int64)
    chunk_win: dict = {}
    rows_acc = 0
    for dr in range(n_drows_p):
        wdw = dr // K_C
        c = rows_acc // R_C
        if chunk_win.get(c, wdw) != wdw:
            rows_acc = _ceil_to(rows_acc, R_C)
        base2[dr] = rows_acc
        end = rows_acc + int(H_in[dr])
        for cc in range(rows_acc // R_C, (end - 1) // R_C + 1):
            chunk_win[cc] = wdw
        rows_acc = end
    R_total = _ceil_to(rows_acc, R_C)
    C = R_total // R_C

    win_of_chunk = np.zeros(C, dtype=np.int64)
    for c in range(C):
        win_of_chunk[c] = chunk_win.get(
            c, win_of_chunk[c - 1] if c else 0)
    win_oh = np.zeros((C, W), dtype=np.float32)
    win_oh[np.arange(C), win_of_chunk] = 1.0

    # run_k[c, i] = window slot (dr % K_C) of the block owning row
    # c*R_C + i, or -1 for padding rows. Distinct blocks sharing a chunk
    # share its window, so slots cannot collide.
    block_of_row = np.full(R_total, -1, dtype=np.int64)
    for dr in range(n_drows_p):
        block_of_row[base2[dr]:base2[dr] + H_in[dr]] = dr
    run_k = np.full(R_total, -1, dtype=np.int16)
    owned = block_of_row >= 0
    run_k[owned] = (block_of_row[owned] % K_C).astype(np.int16)
    run_k = run_k.reshape(C, R_C)

    # per-edge scatter position
    order_s = np.argsort(v, kind="stable")
    seq2 = np.arange(E) - np.concatenate(([0], np.cumsum(
        cnt)))[v[order_s]]
    scatter_pos = ((base2[drow[order_s]] + seq2) * LANES + dlane[order_s])
    sp_by_edge = np.empty(E, dtype=np.int64)
    sp_by_edge[order_s] = scatter_pos
    return C, run_k, win_oh, sp_by_edge, R_total


def _edge_perm_masks(gp_by_edge, sp_by_edge, net_log2):
    """Route the big Benes: scatter position <- gather position for every
    edge, identity-completed on free slots (all of which carry zeros)."""
    N_net = 1 << net_log2
    perm = np.full(N_net, -1, dtype=np.int64)
    perm[sp_by_edge] = gp_by_edge
    free_out = np.flatnonzero(perm < 0)
    used_in = np.zeros(N_net, dtype=bool)
    used_in[gp_by_edge] = True
    perm[free_out] = np.flatnonzero(~used_in)
    return route_packed(perm)


def _node_relabel_masks(relab_out, relab_in, node_flat, n_drows_p):
    """Route the node Benes: in-label dense acc -> out labeling."""
    acc_flat_len = n_drows_p * LANES
    node_net_log2 = int(np.ceil(np.log2(max(node_flat, acc_flat_len, 2))))
    N_nn = 1 << node_net_log2
    nperm = np.full(N_nn, -1, dtype=np.int64)
    nperm[relab_out] = relab_in                # out position <- in position
    free_out = np.flatnonzero(nperm < 0)
    used_in = np.zeros(N_nn, dtype=bool)
    used_in[relab_in] = True
    nperm[free_out] = np.flatnonzero(~used_in)
    return node_net_log2, route_packed(nperm)


def _global_labelings(src, dst, w, n_nodes):
    """Degree stats + out/in relabelings shared by all shards."""
    out_deg = np.bincount(src, minlength=n_nodes)
    in_deg = np.bincount(dst, minlength=n_nodes)
    wsum = np.bincount(src, weights=w, minlength=n_nodes)
    n_rows = _ceil_to(n_nodes, LANES) // LANES
    G = _ceil_to(n_rows, SG_ROWS) // SG_ROWS
    relab_out = _relabel_by(out_deg, stripe_groups=G)
    relab_in = _relabel_by(in_deg)
    inv_wsum = np.where(wsum > 0, 1.0 / np.maximum(wsum, 1e-300), 0.0)
    node_flat = G * SG_ROWS * LANES
    valid_out = np.zeros(node_flat, dtype=np.float32)
    valid_out[relab_out] = 1.0
    dangling_out = np.zeros(node_flat, dtype=np.float32)
    dangling_out[relab_out[wsum <= 0]] = 1.0
    n_drows = _ceil_to(n_nodes, LANES) // LANES
    n_drows_p = _ceil_to(n_drows, K_C)                        # whole windows
    return (G, relab_out, relab_in, inv_wsum, valid_out, dangling_out,
            n_drows_p, wsum)


def build_plan(src: np.ndarray, dst: np.ndarray,
               weights: Optional[np.ndarray], n_nodes: int,
               normalize: bool = True) -> MXUPlan:
    """Precompute layouts + routing for the MXU semiring-SpMV kernel.

    normalize=True bakes w / out-weight-sum multipliers (the column-
    stochastic matrix PageRank iterates); normalize=False bakes plain w
    (the raw A^T other plus-times algorithms — katz — iterate)."""
    plan_counts["build_plan"] += 1
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    E = len(src)
    w = (np.ones(E, dtype=np.float64) if weights is None
         else np.asarray(weights, dtype=np.float64))

    (G, relab_out, relab_in, inv_wsum, valid_out, dangling_out,
     n_drows_p, wsum) = _global_labelings(src, dst, w, n_nodes)
    if not normalize:
        inv_wsum = np.ones_like(inv_wsum)

    R_G, rowid, mult, gp_by_edge = _gather_layout(
        src, w, relab_out, inv_wsum, G)
    C, run_k, win_oh, sp_by_edge, R_total = _scatter_layout(
        dst, relab_in, n_drows_p)

    net = max(G * R_G * LANES, R_total * LANES, 2)
    net_log2 = int(np.ceil(np.log2(net)))
    masks_packed = _edge_perm_masks(gp_by_edge, sp_by_edge, net_log2)

    node_flat = G * SG_ROWS * LANES
    node_net_log2, node_masks_packed = _node_relabel_masks(
        relab_out, relab_in, node_flat, n_drows_p)

    return MXUPlan(
        n_nodes=n_nodes, G=G, R_G=R_G, rowid=rowid, mult=mult,
        out_relabel=relab_out, valid_out=valid_out,
        dangling_out=dangling_out,
        net_log2=net_log2, masks_packed=masks_packed,
        C=C, run_k=run_k, win_oh=win_oh, W=n_drows_p // K_C,
        in_relabel=relab_in,
        node_net_log2=node_net_log2, node_masks_packed=node_masks_packed,
        wsum=wsum)


# the fields that fix a plan's routes and layouts: a plan derived from
# another (``unnormalized_plan``) shares them, array for array
ROUTED_FIELDS = ("rowid", "out_relabel", "valid_out", "masks_packed",
                 "run_k", "win_oh", "in_relabel", "node_masks_packed")


def unnormalized_plan(plan: MXUPlan, src: np.ndarray,
                      weights: Optional[np.ndarray]) -> MXUPlan:
    """The ``normalize=False`` plan of the edges (``src``, ``weights``, in
    the order they were given) a normalized ``plan`` was built from:
    ``mult`` laid out anew with unit out-weight multipliers under the
    plan's out labeling, every other field the plan's own (the same
    arrays).  Equal, bit for bit, to ``build_plan(..., normalize=False)``:
    normalization changes the multipliers alone, never the labelings or
    the slot each edge takes."""
    src = np.asarray(src, dtype=np.int64)
    w = (np.ones(len(src), dtype=np.float64) if weights is None
         else np.asarray(weights, dtype=np.float64))
    _, _, mult, _ = _gather_layout(src, w, plan.out_relabel,
                                   np.ones(plan.n_nodes), plan.G,
                                   force_R_G=plan.R_G)
    return dataclasses.replace(plan, mult=mult)


# ---------------------------------------------------------------------------
# delta plans: O(changed-edges) refresh instead of a full replan
# ---------------------------------------------------------------------------

@dataclass
class DeltaPlan:
    """Side-plan covering edges added/removed since the base plan.

    The base plan keeps serving its (now stale) edges; this plan routes
    only the delta, and two correction vectors make the combination
    exact:
      - scale_out: rank is pre-scaled by wsum_old/wsum_new per source
        before the BASE expand, so stale w/wsum_old multipliers become
        w/wsum_new;
      - removed edges ride the delta net with NEGATIVE multipliers
        -w/wsum_new, cancelling the base contribution exactly;
      - dangling_out replaces the base vector (nodes may gain/lose all
        out-edges).
    Valid only while the node set is unchanged.
    """
    n_delta: int
    R_G: int
    rowid: np.ndarray          # (G, R_G) int16
    mult: np.ndarray           # (G, R_G, LANES) f32 (signed)
    net_log2: int
    masks_packed: np.ndarray
    C: int
    run_k: np.ndarray
    win_oh: np.ndarray
    scale_out: np.ndarray      # (node_flat,) f32
    dangling_out: np.ndarray   # (node_flat,) f32 — replaces base's
    wsum: np.ndarray           # updated per-node out-weight sums


def build_delta_plan(base: MXUPlan,
                     add_src, add_dst, add_w=None,
                     rem_src=None, rem_dst=None, rem_w=None) -> DeltaPlan:
    """Build the O(delta) side-plan. All ids are ORIGINAL node ids and
    must be < base.n_nodes (node additions require a full replan).

    R_G and C are padded to powers of two (C with dead chunks: run_k -1
    rows extract nothing, zero win_oh rows route no window), so that
    growing deltas keep the same shapes between bucket jumps.

    The delta net is never below 2^15 slots: the scatter layout gives
    every dst row of the base's whole 256-row windows at least one row."""
    if base.wsum is None:
        raise ValueError("base plan predates delta support (no wsum)")
    plan_counts["build_delta_plan"] += 1
    n = base.n_nodes
    add_src = np.asarray(add_src, dtype=np.int64)
    add_dst = np.asarray(add_dst, dtype=np.int64)
    a_w = (np.ones(len(add_src)) if add_w is None
           else np.asarray(add_w, dtype=np.float64))
    rem_src = np.asarray(
        rem_src if rem_src is not None else [], dtype=np.int64)
    rem_dst = np.asarray(
        rem_dst if rem_dst is not None else [], dtype=np.int64)
    r_w = (np.ones(len(rem_src)) if rem_w is None
           else np.asarray(rem_w, dtype=np.float64))
    for arr in (add_src, add_dst, rem_src, rem_dst):
        if len(arr) and (arr.min() < 0 or arr.max() >= n):
            raise ValueError("delta references nodes outside the base plan")

    wsum_new = base.wsum.copy()
    if len(add_src):
        wsum_new += np.bincount(add_src, weights=a_w, minlength=n)
    if len(rem_src):
        wsum_new -= np.bincount(rem_src, weights=r_w, minlength=n)
    wsum_new[np.abs(wsum_new) < 1e-9] = 0.0     # cancel fp dust at zero
    inv_new = np.where(wsum_new > 0, 1.0 / np.maximum(wsum_new, 1e-300),
                       0.0)

    d_src = np.concatenate([add_src, rem_src])
    d_dst = np.concatenate([add_dst, rem_dst])
    d_w = np.concatenate([a_w, -r_w])           # removals route negative

    G = base.G
    n_drows_p = base.W * K_C
    R_G, rowid, mult, gp = _gather_layout(d_src, d_w, base.out_relabel,
                                          inv_new, G)
    if R_G & (R_G - 1):
        R_G = 1 << R_G.bit_length()
        R_G, rowid, mult, gp = _gather_layout(
            d_src, d_w, base.out_relabel, inv_new, G, force_R_G=R_G)
    C, run_k, win_oh, sp, R_total = _scatter_layout(
        d_dst, base.in_relabel, n_drows_p)
    if C & (C - 1):
        C_pad = 1 << C.bit_length()
        run_k = np.concatenate(
            [run_k, np.full((C_pad - C, R_C), -1, dtype=run_k.dtype)])
        win_oh = np.concatenate(
            [win_oh, np.zeros((C_pad - C, win_oh.shape[1]),
                              dtype=win_oh.dtype)])
        C, R_total = C_pad, C_pad * R_C
    net = max(G * R_G * LANES, R_total * LANES, 2)
    net_log2 = int(np.ceil(np.log2(net)))
    masks_packed = _edge_perm_masks(gp, sp, net_log2)

    node_flat = G * SG_ROWS * LANES
    # exact-1 scale for untouched nodes: only rescale where wsum changed
    changed = wsum_new != base.wsum
    scale_nodes = np.ones(n, dtype=np.float64)
    scale_nodes[changed] = base.wsum[changed] * inv_new[changed]
    scale_out = np.zeros(node_flat, dtype=np.float32)
    scale_out[base.out_relabel] = scale_nodes
    dangling_out = np.zeros(node_flat, dtype=np.float32)
    dangling_out[base.out_relabel[wsum_new <= 0]] = 1.0

    return DeltaPlan(
        n_delta=len(d_src), R_G=R_G, rowid=rowid, mult=mult,
        net_log2=net_log2, masks_packed=masks_packed,
        C=C, run_k=run_k, win_oh=win_oh,
        scale_out=scale_out, dangling_out=dangling_out, wsum=wsum_new)


# ---------------------------------------------------------------------------
# device kernel
# ---------------------------------------------------------------------------

def plan_from_arrays(fields: dict) -> MXUPlan:
    """The port's MXUPlan from the field dict of an MXUPlan with the same
    fields (numpy arrays and ints — e.g. ``dataclasses.asdict`` of the JAX
    package's plan), so one routed plan can feed both packages."""
    kw = {}
    for f in dataclasses.fields(MXUPlan):
        v = fields.get(f.name)
        if isinstance(v, (int, np.integer)):
            v = int(v)
        elif v is not None:
            v = np.asarray(v)
        kw[f.name] = v
    return MXUPlan(**kw)


def pagerank_mxu_epilogue(rank, acc, env, P):
    """The fused PageRank update + convergence partial, applied to the
    matvec's out-labeled accumulator (shared formula:
    semiring.pagerank_update)."""
    dm = torch.sum(rank * env["dangling"])
    new_rank = pagerank_update(acc, dm, env["valid"], env["n_f"],
                               P["damping"])
    err = torch.sum(torch.abs(new_rank - rank))
    return new_rank, err


def _flat_layout(N: int):
    return (N // LANES, LANES) if N >= LANES else (N,)


def resolve_route_dtype(route_dtype=None) -> torch.dtype:
    """route_dtype as given, or for None the MEMGRAPH_TPU_ROUTE_DTYPE
    variable's: ``bf16`` -> torch.bfloat16, anything else (or unset) ->
    torch.float32, as the reference's make_semiring_kernel reads it."""
    if route_dtype is not None:
        return route_dtype
    return (torch.bfloat16 if os.environ.get(
        "MEMGRAPH_TPU_ROUTE_DTYPE", "f32") == "bf16" else torch.float32)


def _put(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _put_route(masks_packed, net_log2, dtype, dev, split: dict = None):
    """(mid_idx, outer_idx, spec) of one routed network on dev: the middle
    stages composed into one tile-local index, each outer side into one
    row index (None when the net fits one tile), by the stage kernels on
    the card straight from the router's packed mask rows (uploaded, used
    and freed: at most 47 rows of 2 MB for the 2^24 edge net).

    split, where given, receives where the time went: ``mask_prep_s``
    (host: selecting the live rows), ``upload_s`` (host wall time of the
    rows' copy to dev, synchronised) and, on the card, ``compose_ms``
    (CUDA events around the stage kernels; None on the CPU)."""
    t0 = time.perf_counter()
    spec, mid, out = build_masks(masks_packed, net_log2, K_BY_DTYPE[dtype])
    t1 = time.perf_counter()
    mid, out = _put(mid, dev), None if out is None else _put(out, dev)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
    t2 = time.perf_counter()
    route = (compose_mid(mid, spec),
             None if out is None else compose_outer(out, spec), spec)
    if cuda:
        end.record()
        end.synchronize()
    if split is not None:
        split.update(mask_prep_s=t1 - t0, upload_s=t2 - t1,
                     compose_ms=start.elapsed_time(end) if cuda else None)
    return route


def _put_layout(rowid, mult, run_k, win_oh, dev):
    """One gather/scatter layout (the base plan's or a delta's) on dev:
    (oh, mult, ohe_t, win_oh_t).  oh (G, R_G, 128) is the expand's
    one-hot; ohe_t (C, K_C, R_C) the extract's, transposed for bmm and
    f32, so a bf16 route is upcast (exactly) and summed in f32."""
    rowid = _put(rowid.astype(np.int64), dev)
    run_k = _put(run_k.astype(np.int64), dev)
    oh = (rowid[:, :, None] == torch.arange(SG_ROWS, device=dev)
          ).to(torch.float32)
    ohe_t = ((run_k[:, :, None] == torch.arange(K_C, device=dev))
             & (run_k[:, :, None] >= 0)
             ).to(torch.float32).transpose(1, 2).contiguous()
    return (oh, _put(mult.astype(np.float32), dev), ohe_t,
            _put(win_oh.astype(np.float32).T, dev))           # (W, C)


def _route_acc(rank_planes, layout, route, route_dtype):
    """Expand -> Benes route -> one-hot reduce/extract of one layout: the
    (W, K_C*128) f32 window accumulator, in-degree labeling."""
    oh, mult, ohe_t, win_oh_t = layout
    N_net, C = 1 << route[2].net_log2, ohe_t.shape[0]
    T = torch.bmm(oh, rank_planes)                          # grw,gwl->grl
    contrib = (T * mult).to(route_dtype).reshape(-1)
    x2 = torch.zeros(N_net, dtype=route_dtype, device=rank_planes.device)
    x2[:contrib.numel()] = contrib
    x2 = benes_apply(x2.view(_flat_layout(N_net)), *route)
    xc = x2.reshape(-1)[:C * R_C * LANES].view(C, R_C, LANES)
    per_chunk = torch.bmm(ohe_t, xc.to(torch.float32))      # cik,cil->ckl
    return win_oh_t @ per_chunk.view(C, K_C * LANES)        # cw,ckl->wkl


def place_plan(plan: MXUPlan, route_dtype=None, device=None) -> dict:
    """The base plan's device state: its edge and node routes, its layout
    and the valid-node vector, placed once, with the seconds it took
    (``placement_s``) and each route's placement split (``route_split``,
    see ``_put_route``).  Every run of the plan on that device and route
    dtype can share it (``make_semiring_kernel``'s ``placed``), the delta
    runs of later snapshots included."""
    dev = resolve_device(device)
    route_dtype = resolve_route_dtype(route_dtype)
    t0 = time.perf_counter()
    split = {"edge": {}, "node": {}}
    placed = {"plan": plan, "route_dtype": route_dtype, "device": dev,
              "edge": _put_route(plan.masks_packed, plan.net_log2,
                                 route_dtype, dev, split["edge"]),
              "node": _put_route(plan.node_masks_packed, plan.node_net_log2,
                                 torch.float32, dev, split["node"]),
              "route_split": split,
              "layout": _put_layout(plan.rowid, plan.mult, plan.run_k,
                                    plan.win_oh, dev),
              "valid": _put(plan.valid_out.astype(np.float32), dev)}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    placed["placement_s"] = time.perf_counter() - t0
    return placed


def place_mult(placed: dict, plan: MXUPlan) -> dict:
    """``plan``'s device state from ``placed``, another plan's: the edge
    and node routes, one-hots and valid vector shared, only ``mult``
    uploaded.  ``plan`` must share every routed field (``ROUTED_FIELDS``)
    with the placed plan, as ``unnormalized_plan`` makes it; anything else
    raises.  ``placement_s`` counts the upload alone."""
    base = placed["plan"]
    if any(getattr(plan, f) is not getattr(base, f) for f in ROUTED_FIELDS):
        raise ValueError("the plan's routes are not the placed plan's")
    dev = placed["device"]
    t0 = time.perf_counter()
    oh, _, ohe_t, win_oh_t = placed["layout"]
    out = dict(placed, plan=plan, route_split={},
               layout=(oh, _put(plan.mult.astype(np.float32), dev), ohe_t,
                       win_oh_t), shares=placed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out["placement_s"] = time.perf_counter() - t0
    return out


def make_semiring_kernel(plan: MXUPlan, epilogue, route_dtype=None,
                         delta: DeltaPlan = None,
                         x0_default: str = "uniform", device=None,
                         placed: dict = None):
    """Returns fn(x0_flat, params, max_iter, tol) -> (x_flat, err, iters);
    state vectors are flat in OUT labeling, length G*SG_ROWS*LANES.  The
    matvec (expand -> Benes route -> one-hot reduce/extract -> node
    relabel) is fixed ⊕ = sum machinery, while the fused
    ``epilogue(x, acc, env, params) -> (new_x, err)`` supplies the
    algorithm (env carries valid / dangling / n_f; params is a dict of
    scalars, placed as f32 tensors).  ⊗ is baked into the plan's
    multipliers (build_plan(normalize=...)).

    route_dtype: dtype of the per-edge contributions through the big Benes
    (the dominant memory traffic).  torch.bfloat16 halves it; sums still
    accumulate in f32.  torch.float32 is the exact path.  None takes
    MEMGRAPH_TPU_ROUTE_DTYPE's (resolve_route_dtype).

    delta: optional DeltaPlan — per iteration the base expand reads rank
    pre-scaled by delta.scale_out, the delta edges (expanded from the
    UNSCALED rank) route through their own net, placed and applied by the
    same Benes kernels as the base nets, and both accumulators sum before
    the node relabel; delta.dangling_out replaces the plan's dangling
    vector.  Exact for edge additions AND removals.

    placed: the base plan's device state from ``place_plan`` (or
    ``place_mult``) on this device and route dtype, for this very plan;
    None places it here.  The base routes depend
    only on the plan, so a delta run shares them with the base snapshot's
    runs and places only its delta (the base routes, one-hots and valid
    vector are then skipped); ``run.placement_s`` counts only what the
    call placed, and ``run.route_split`` holds the delta route's
    placement split (``_put_route``; empty without a delta).

    x0_default: the on-device start when x0 is None — "uniform"
    (valid/n, pagerank) or "zeros" (katz).

    The loop keeps the JAX package's rule: err starts at +inf and the
    body runs while (err > tol) & (it < max_iterations); err is read on
    the host once per iteration.
    """
    dev = resolve_device(device)
    route_dtype = resolve_route_dtype(route_dtype)
    t0 = time.perf_counter()
    route_split = {}
    G = plan.G
    N_nn = 1 << plan.node_net_log2
    node_flat = G * SG_ROWS * LANES
    n_f = float(plan.n_nodes)

    if placed is None:
        placed = place_plan(plan, route_dtype, dev)
    elif (placed["plan"] is not plan or placed["route_dtype"] != route_dtype
          or placed["device"] != dev):
        raise ValueError("placed state belongs to another plan, route "
                         "dtype or device")
    big, node, layout = placed["edge"], placed["node"], placed["layout"]
    dangling = plan.dangling_out
    if delta is not None:
        d_route = _put_route(delta.masks_packed, delta.net_log2,
                             route_dtype, dev, route_split.setdefault(
                                 "delta", {}))
        d_layout = _put_layout(delta.rowid, delta.mult, delta.run_k,
                               delta.win_oh, dev)
        d_scale = _put(delta.scale_out.astype(np.float32), dev)
        dangling = delta.dangling_out        # REPLACES the base vector
    env = {"valid": placed["valid"],
           "dangling": _put(dangling.astype(np.float32), dev), "n_f": n_f}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    placement_s = time.perf_counter() - t0

    def matvec(rank_flat):
        """⊕ = sum matvec in OUT labeling; ⊗ is baked into mult."""
        # the base expand reads rank pre-scaled so that stale w/wsum_old
        # multipliers become w/wsum_new (exact; see DeltaPlan)
        base_in = rank_flat if delta is None else rank_flat * d_scale
        accw = _route_acc(base_in.view(G, SG_ROWS, LANES), layout, big,
                          route_dtype)
        if delta is not None:
            accw = accw + _route_acc(rank_flat.view(G, SG_ROWS, LANES),
                                     d_layout, d_route, route_dtype)
        xa = torch.zeros(N_nn, dtype=torch.float32, device=dev)
        xa[:accw.numel()] = accw.reshape(-1)
        xa = benes_apply(xa.view(_flat_layout(N_nn)), *node)
        return xa.reshape(-1)[:node_flat]

    def run(x0, params, max_iterations, tol):
        """x0 = None starts from the on-device default state (uniform
        distribution or zeros)."""
        if x0 is None:
            x = (torch.zeros_like(env["valid"]) if x0_default == "zeros"
                 else env["valid"] * torch.tensor(1.0 / n_f,
                                                  dtype=torch.float32,
                                                  device=dev))
        else:
            x = torch.as_tensor(x0, dtype=torch.float32).to(dev)
        P = {k: torch.tensor(float(v), dtype=torch.float32, device=dev)
             for k, v in params.items()}
        tol = float(np.float32(tol))
        # the one-hot matmuls carry rank values, which TF32 would round
        exact_f32_matmuls()
        err, it = float("inf"), 0
        while err > tol and it < max_iterations:
            acc = matvec(x)
            x, err_t = epilogue(x, acc, env, P)
            err = float(err_t)
            it += 1
        return x, err, it

    run.placement_s = placement_s
    run.route_split = route_split
    run.routes = {"edge": big, "node": node}
    if delta is not None:
        run.routes["delta"] = d_route
    run.device = dev
    return run


def make_pagerank_kernel(plan: MXUPlan, route_dtype=None, device=None,
                         delta: DeltaPlan = None, placed: dict = None):
    """The semiring kernel with the fused PageRank epilogue.  Returns
    fn(rank0_flat, damping, max_iter, tol) -> (rank_flat, err, iters)."""
    run = make_semiring_kernel(plan, epilogue=pagerank_mxu_epilogue,
                               route_dtype=route_dtype, delta=delta,
                               x0_default="uniform", device=device,
                               placed=placed)

    def run_pr(rank0, damping, max_iterations, tol):
        return run(rank0, {"damping": damping}, max_iterations, tol)

    for attr in ("placement_s", "route_split", "routes", "device"):
        setattr(run_pr, attr, getattr(run, attr))
    return run_pr


def pagerank_mxu(src, dst, weights, n_nodes, damping=0.85,
                 max_iterations=100, tol=1e-6, plan: MXUPlan = None,
                 device=None):
    """End-to-end: build plan (or reuse), run kernel, return ranks in
    ORIGINAL node ids (a tensor on the device) plus (err, iters)."""
    if plan is None:
        plan = build_plan(src, dst, weights, n_nodes)
    run = make_pagerank_kernel(plan, device=device)
    rank, err, iters = run(None, damping, max_iterations, tol)
    relabel = torch.from_numpy(plan.out_relabel).to(run.device)
    return rank[relabel], err, iters


# ---------------------------------------------------------------------------
# plan persistence (routing a 10M-edge graph costs ~30s host-side)
# ---------------------------------------------------------------------------

_PLAN_VERSION = 4


def save_plan(plan: MXUPlan, path: str) -> None:
    np.savez_compressed(
        path, version=_PLAN_VERSION, n_nodes=plan.n_nodes, G=plan.G,
        R_G=plan.R_G, rowid=plan.rowid, mult=plan.mult,
        out_relabel=plan.out_relabel, valid_out=plan.valid_out,
        dangling_out=plan.dangling_out, net_log2=plan.net_log2,
        masks_packed=plan.masks_packed, C=plan.C, run_k=plan.run_k,
        win_oh=plan.win_oh, W=plan.W, in_relabel=plan.in_relabel,
        node_net_log2=plan.node_net_log2,
        node_masks_packed=plan.node_masks_packed,
        wsum=plan.wsum if plan.wsum is not None else np.zeros(0))


def load_plan(path: str) -> Optional[MXUPlan]:
    """The saved plan, or None when the file is missing, damaged or of
    another version (the caller then rebuilds)."""
    try:
        z = np.load(path)
        if int(z["version"]) != _PLAN_VERSION:
            return None
        return MXUPlan(
            n_nodes=int(z["n_nodes"]), G=int(z["G"]), R_G=int(z["R_G"]),
            rowid=z["rowid"], mult=z["mult"], out_relabel=z["out_relabel"],
            valid_out=z["valid_out"], dangling_out=z["dangling_out"],
            net_log2=int(z["net_log2"]), masks_packed=z["masks_packed"],
            C=int(z["C"]), run_k=z["run_k"],
            win_oh=z["win_oh"], W=int(z["W"]), in_relabel=z["in_relabel"],
            node_net_log2=int(z["node_net_log2"]),
            node_masks_packed=z["node_masks_packed"],
            wsum=z["wsum"] if z["wsum"].size else None)
    except (OSError, KeyError, ValueError, zipfile.BadZipFile):
        return None
